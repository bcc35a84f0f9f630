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

``traversal_cohort_*`` fuse BFS and wBFS lanes into one cohort for the
serving tier: one batched sweep a round, ``map_lanes`` picking each lane's
map, so on the card a mixed ``sparse_streamed`` round is one fused launch.
"""
from __future__ import annotations

import torch

from ..core.backend import GraphLike
from ..core.bucketing import NULL_BUCKET, make_buckets
from ..core.edgemap import edgemap_reduce_batched
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


def traversal_cohort_init(g: GraphLike, ops, sources):
    """Build the fused BFS+wBFS cohort state for one serving drain.

    ``ops`` is a sequence of ``"bfs"`` / ``"wbfs"`` lane kinds and
    ``sources`` the matching int vertex ids; a source of ``-1`` makes an
    inert padding lane (empty root set: never in a frontier, never active,
    never charged).  Returns ``(state, weighted)``: ``state`` is the dict
    :func:`traversal_cohort_rounds` advances (``parents`` / ``levels``
    int32[B, n] for BFS lanes, ``dist`` int32[B, n] / ``settled`` bool[B, n]
    for wBFS lanes, ``frontier`` bool[B, n], the round counter ``rnd``) and
    ``weighted`` the tuple of per-lane bools that picks each lane's map
    (the ``map_lanes`` of the shared sweep).

    The serving scheduler repacks this state between quanta by indexing the
    leading B axis, which is legal because every batched edgeMap is per-lane
    independent."""
    n, dev = g.n, g.device
    ops = tuple(ops)
    for op in ops:
        if op not in ("bfs", "wbfs"):
            raise ValueError(f"cohort lanes must be 'bfs' or 'wbfs', got {op!r}")
    srcs = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    B = len(ops)
    if tuple(srcs.shape) != (B,):
        raise ValueError(f"sources must be int[{B}], got shape {tuple(srcs.shape)}")
    weighted = tuple(op == "wbfs" for op in ops)
    wvec = torch.tensor(weighted, dtype=torch.bool, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    roots = ids.to(torch.int64)[None, :] == srcs[:, None]
    broots = roots & ~wvec[:, None]
    wroots = roots & wvec[:, None]
    idsb = ids.expand(B, n)
    state = {
        "parents": torch.where(broots, idsb, UNVISITED),
        "levels": torch.where(broots, 0, UNVISITED).to(torch.int32),
        "dist": torch.where(wroots, 0, INF_I32).to(torch.int32),
        "settled": torch.zeros((B, n), dtype=torch.bool, device=dev),
        "frontier": broots,
        "rnd": 0,
    }
    return state, weighted


def traversal_cohort_active(state, weighted, n: int) -> torch.Tensor:
    """bool[B]: which cohort lanes still have work left.

    A BFS lane is active while its frontier is nonempty and ``rnd < n``; a
    wBFS lane while any vertex sits in a non-NULL bucket.  Activity is
    prefix-monotone (a drained lane never reactivates), which lets the
    scheduler rebuild round r's active set from per-lane round totals."""
    b_active = state["frontier"].any(dim=1) & (state["rnd"] < n)
    if not any(weighted):
        return b_active
    wvec = torch.tensor(weighted, dtype=torch.bool, device=b_active.device)
    bo = _bucket_of(state["dist"], state["settled"])
    w_active = wvec & (bo.min(dim=1).values < NULL_BUCKET)
    if all(weighted):
        return w_active
    return w_active | (~wvec & b_active)


def traversal_cohort_rounds(
    g: GraphLike,
    state,
    weighted,
    *,
    quantum: int = 4,
    mode: str = "auto",
    plan=None,
):
    """Advance a fused BFS+wBFS cohort by up to ``quantum`` shared rounds.

    Each round is ONE batched edge sweep shared by every lane: wBFS lanes
    relax distances (``map_lanes`` selects ``_relax``), BFS lanes carry
    candidate parent ids through the identity map; both are min over int32,
    so on the card a ``sparse_streamed`` round is one fused launch.  Stops
    early when every lane drains.  Returns ``(state, lane_rounds, active)``:
    ``lane_rounds`` int32[B] counts the rounds each lane was active in this
    call, ``active`` bool[B] flags lanes with work left.  Each lane's rows
    equal its single-query ``bfs`` / ``wbfs`` run."""
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    weighted = tuple(bool(w) for w in weighted)
    B = len(weighted)
    any_w, all_w = any(weighted), all(weighted)
    wvec = torch.tensor(weighted, dtype=torch.bool, device=dev)
    idsb = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    sweep_kw = {}
    if any_w:
        sweep_kw["map_fn"] = _relax
        if not all_w:
            sweep_kw["map_lanes"] = wvec
    st = dict(state)
    lane_rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(quantum):
        active = traversal_cohort_active(st, weighted, n)
        if not bool(active.any()):
            break
        parents, levels = st["parents"], st["levels"]
        dist, settled = st["dist"], st["settled"]
        rnd = st["rnd"]
        bfr = st["frontier"] if rnd < n else torch.zeros_like(st["frontier"])
        if any_w:
            bo = _bucket_of(dist, settled)
            bid = bo.min(dim=1).values
            run = wvec & (bid < NULL_BUCKET)
            members = (bo == bid[:, None]) & ~settled & run[:, None]
            d = torch.where(members, dist, INF_I32).min(dim=1).values
            wfr = members & (dist == d[:, None])
            settled = settled | wfr
            fr = torch.where(wvec[:, None], wfr, bfr)
            xs = torch.where(wvec[:, None], dist, idsb)
        else:
            fr, xs = bfr, idsb
        cand, touched = edgemap_reduce_batched(
            g, fr, xs, monoid="min", mode=mode, plan=plan, **sweep_kw
        )
        newly = touched & (parents == UNVISITED) & ~wvec[:, None]
        st["parents"] = torch.where(newly, cand, parents)
        st["levels"] = torch.where(newly, rnd + 1, levels)
        if any_w:
            improve = touched & ~settled & (cand < dist) & wvec[:, None]
            st["dist"] = torch.where(improve, cand, dist)
        st["settled"] = settled
        st["frontier"] = newly
        st["rnd"] = rnd + 1
        lane_rounds += active.to(torch.int32)
    return st, lane_rounds, traversal_cohort_active(st, weighted, n)
