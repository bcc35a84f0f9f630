"""Shortest-path problems (§4.3.1) — BFS and wBFS (integral Dijkstra).

Both are frontier loops over EDGEMAPCHUNKED (direction-optimized), run by
``round_loop``.  Mutable state is strictly O(n) words.  CAS-based
``updateAtomic`` from the paper's BFS (Fig. 4) becomes an idempotent
min-reduction over candidate parents — any in-frontier parent is a valid
BFS-tree parent, so priority-min is a legal determinization.

``bfs_batched`` / ``wbfs_batched`` are the serving-path entry points: B
queries advance in lockstep through ONE batched edgeMap per round, so the
edge sweep is shared by the whole batch.  Finished queries' state is inert
in later rounds, which makes every query's result bit-identical to its own
single-query run.
"""
from __future__ import annotations

import torch

from ..core.backend import GraphLike
from ..core.bucketing import NULL_BUCKET, make_buckets
from ..core.plan import round_loop
from ..core.primitives import INF_I32

UNVISITED = -1


def _root_masks(g: GraphLike, sources) -> torch.Tensor:
    """Normalize (B,) int sources or (B, n) root masks to bool[B, n].

    Dispatch is by RANK, never dtype: a 2-D array is always per-query root
    masks, a 1-D non-bool array is always source ids."""
    n = g.n
    roots = torch.as_tensor(sources, device=g.device)
    if roots.dim() == 2:
        if roots.shape[1] != n:
            raise ValueError(f"root masks must be (B, {n}), got {tuple(roots.shape)}")
        return roots.to(torch.bool)
    if roots.dim() == 1 and roots.dtype != torch.bool:
        ids = torch.arange(n, dtype=torch.int64, device=g.device)
        return ids[None, :] == roots.to(torch.int64)[:, None]
    raise ValueError(
        f"sources must be int[B] vertex ids or (B, {n}) root masks, got "
        f"{roots.dtype}{list(roots.shape)}"
    )


def _relax(xs, w):
    """wBFS relaxation: int32 saturating xs + w."""
    wi = w.to(torch.int32)
    return torch.where(xs >= INF_I32 - (1 << 24), INF_I32, xs + wi)


# the fused round's name for this map (``core.edgemap.stream_round_route``)
_relax.kernel_map = "sat_add_i32"


def _bucket_of(dist, settled):
    """Per-vertex bucket id for the dense semi-eager wBFS bucketing."""
    return torch.where(
        settled | (dist == INF_I32), NULL_BUCKET, dist.clamp(max=NULL_BUCKET - 1)
    )


def _bfs_epilogue(state, cand, touched):
    rnd, parents, levels, _ = state
    newly = touched & (parents == UNVISITED)
    parents = torch.where(newly, cand, parents)
    levels = torch.where(newly, rnd + 1, levels)
    return rnd + 1, parents, levels, newly


def _wbfs_epilogue(state, cand, touched):
    dist, settled = state
    improve = touched & ~settled & (cand < dist)
    return torch.where(improve, cand, dist), settled


def bfs(g: GraphLike, src: int, *, mode: str = "auto", plan=None):
    """Breadth-first search.  Returns (parents int32[n], levels int32[n]).

    parents[v] = -1 if unreachable, src for the source itself.
    PSAM: O(m) work, O(d_G log n) depth, O(n) words small memory (Thm 4.2).
    """
    n, dev = g.n, g.device
    src = int(src)
    parents0 = torch.full((n,), UNVISITED, dtype=torch.int32, device=dev)
    parents0[src] = src
    levels0 = torch.full((n,), UNVISITED, dtype=torch.int32, device=dev)
    levels0[src] = 0
    frontier0 = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier0[src] = True
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    def sweep_inputs(state):
        return state, state[3], ids

    def cond(state):
        rnd, _, _, frontier = state
        return rnd < n and bool(frontier.any())

    _, parents, levels, _ = round_loop(
        g, (0, parents0, levels0, frontier0),
        sweep_inputs=sweep_inputs, epilogue=_bfs_epilogue, cond_fn=cond,
        monoid="min", plan=plan, mode=mode,
    )
    return parents, levels


def bfs_batched(g: GraphLike, sources, *, mode: str = "auto", plan=None):
    """B concurrent BFS queries through one shared edge sweep per round.

    ``sources`` is either int[B] source vertices or bool[B, n] per-query
    root masks.  Returns (parents int32[B, n], levels int32[B, n]), each row
    bit-identical to the corresponding single-query ``bfs`` run on the
    same plan: a drained query's empty frontier touches nothing."""
    n = g.n
    roots = _root_masks(g, sources)
    B = roots.shape[0]
    idsb = torch.arange(n, dtype=torch.int32, device=g.device).expand(B, n)
    parents0 = torch.where(roots, idsb, UNVISITED)
    levels0 = torch.where(roots, 0, UNVISITED).to(torch.int32)

    def sweep_inputs(state):
        return state, state[3], idsb

    def cond(state):
        rnd, _, _, frontier = state
        return rnd < n and bool(frontier.any())

    _, parents, levels, _ = round_loop(
        g, (0, parents0, levels0, roots),
        sweep_inputs=sweep_inputs, epilogue=_bfs_epilogue, cond_fn=cond,
        monoid="min", plan=plan, mode=mode, batched=True,
    )
    return parents, levels


def wbfs(g: GraphLike, src: int, *, mode: str = "auto", plan=None):
    """Integral-weight SSSP via bucketed Dijkstra (Julienne-style, App. B).

    Weights are truncated to int32.  Returns dist int32[n] (INF for
    unreachable).  Each round extracts the minimum bucket and settles only
    its exact minimum distance, keeping Dijkstra's invariant over the full
    int32 range."""
    n, dev = g.n, g.device
    dist0 = torch.full((n,), INF_I32, dtype=torch.int32, device=dev)
    dist0[int(src)] = 0
    settled0 = torch.zeros(n, dtype=torch.bool, device=dev)

    def sweep_inputs(state):
        dist, settled = state
        _, members, _ = make_buckets(_bucket_of(dist, settled)).next_bucket()
        members = members & ~settled
        d = torch.where(members, dist, INF_I32).min()
        frontier = members & (dist == d)
        return (dist, settled | frontier), frontier, dist

    def cond(state):
        return make_buckets(_bucket_of(*state)).next_bucket()[2]

    dist, _ = round_loop(
        g, (dist0, settled0),
        sweep_inputs=sweep_inputs, epilogue=_wbfs_epilogue, cond_fn=cond,
        monoid="min", plan=plan, map_fn=_relax, mode=mode,
    )
    return dist


def wbfs_batched(g: GraphLike, sources, *, mode: str = "auto", plan=None):
    """B concurrent wBFS queries, one edge sweep each round.  ``sources`` is
    int[B]; returns dist int32[B, n], each row bit-identical to ``wbfs``.

    A per-query ``run`` flag stops a drained query from mutating its row
    while the rest of the batch finishes."""
    n, dev = g.n, g.device
    srcs = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    dist0 = torch.where(ids[None, :] == srcs[:, None], 0, INF_I32).to(torch.int32)
    settled0 = torch.zeros(dist0.shape, dtype=torch.bool, device=dev)

    def sweep_inputs(state):
        dist, settled = state
        bo = _bucket_of(dist, settled)
        bid = bo.min(dim=1).values                     # per-query next bucket
        run = bid < NULL_BUCKET                        # queries with work left
        members = (bo == bid[:, None]) & ~settled & run[:, None]
        d = torch.where(members, dist, INF_I32).min(dim=1).values
        frontier = members & (dist == d[:, None])
        return (dist, settled | frontier), frontier, dist

    def cond(state):
        return bool((_bucket_of(*state) < NULL_BUCKET).any())

    dist, _ = round_loop(
        g, (dist0, settled0),
        sweep_inputs=sweep_inputs, epilogue=_wbfs_epilogue, cond_fn=cond,
        monoid="min", plan=plan, map_fn=_relax, mode=mode, batched=True,
    )
    return dist
