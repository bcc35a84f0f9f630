"""Shortest-path problems (§4.3.1) — BFS, wBFS (integral Dijkstra),
Bellman-Ford, widest path and single-source betweenness.

Each is a frontier loop over EDGEMAPCHUNKED (direction-optimized), run by
``round_loop`` or a Python loop on a host-read predicate.  Mutable state is
strictly O(n) words.  CAS-based
``updateAtomic`` from the paper's BFS (Fig. 4) becomes an idempotent
min-reduction over candidate parents — any in-frontier parent is a valid
BFS-tree parent, so priority-min is a legal determinization.

``bfs_batched`` / ``wbfs_batched`` are the serving-path entry points: B
queries advance in lockstep through ONE batched edgeMap per round, so the
edge sweep is shared by the whole batch.  Finished queries' state is inert
in later rounds, which makes every query's result bit-identical to its own
single-query run.

Bellman-Ford (min over float32 ``x + w``, weights of either sign), widest
path (max of ``min(x, w)``) and betweenness (float sums) pass untagged maps
or float state, so on the card their ``sparse_streamed`` rounds run the
chunk loop over kernel 1's decode, never the fused round, which knows only
min over int32.  They count their rounds in
``sage_algorithm_rounds_total{algorithm=...}`` (Bellman-Ford's -inf
propagation and betweenness's backward pass included).

``traversal_cohort_*`` fuse BFS and wBFS lanes into one cohort for the
serving tier: one batched sweep a round, ``map_lanes`` picking each lane's
map, so on the card a mixed ``sparse_streamed`` round is one fused launch.
"""
from __future__ import annotations

import torch

from ..core.backend import GraphLike
from ..core.bucketing import NULL_BUCKET, make_buckets
from ..core.edgemap import edgemap_reduce, edgemap_reduce_batched
from ..core.plan import round_loop
from ..core.primitives import INF_I32
from .covering import count_round

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
    if plan is not None:
        g = plan.prepare(g)
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
    if plan is not None:
        g = plan.prepare(g)
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
    if plan is not None:
        g = plan.prepare(g)
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
    if plan is not None:
        g = plan.prepare(g)
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


def _add(xs, w):
    """Bellman-Ford's relaxation over float32 (untagged: no fused round)."""
    return xs + w


def _bottleneck(xs, w):
    """Widest path's map: the bottleneck of the path so far and the edge."""
    return torch.minimum(xs, w)


def _relaxation_rounds(g: GraphLike, x0, src: int, *, monoid: str, map_fn, algorithm: str,
                       mode: str, plan):
    """Bellman-Ford-style rounds from ``src``: the vertices whose value
    improved (under ``monoid``) relax their edges next, for at most n + 1
    rounds.  Returns (x, the still-improving frontier)."""
    n = g.n
    frontier0 = torch.zeros(n, dtype=torch.bool, device=g.device)
    frontier0[src] = True
    better = torch.lt if monoid == "min" else torch.gt

    def epilogue(state, cand, touched):
        rnd, x, _ = state
        improve = touched & better(cand, x)
        count_round(algorithm)
        return rnd + 1, torch.where(improve, cand, x), improve

    _, x, frontier = round_loop(
        g, (0, x0, frontier0),
        sweep_inputs=lambda state: (state, state[2], state[1]), epilogue=epilogue,
        cond_fn=lambda state: state[0] <= n and bool(state[2].any()),
        monoid=monoid, plan=plan, map_fn=map_fn, mode=mode,
    )
    return x, frontier


def bellman_ford(g: GraphLike, src: int, *, mode: str = "auto", plan=None):
    """General-weight SSSP.  Returns (dist float32[n], has_neg_cycle bool).

    Vertices reachable from a negative cycle get -inf (App. C.1): after at
    most n relaxation rounds the still-improving set seeds a bounded BFS
    that marks everything it reaches."""
    n = g.n
    if plan is not None:
        g = plan.prepare(g)
    src = int(src)
    dist0 = torch.full((n,), float("inf"), dtype=torch.float32, device=g.device)
    dist0[src] = 0.0
    dist, frontier = _relaxation_rounds(g, dist0, src, monoid="min", map_fn=_add,
                                        algorithm="bellman_ford", mode=mode, plan=plan)
    has_neg_cycle = bool(frontier.any())

    # propagate -inf from the still-improving set (bounded BFS)
    dist = torch.where(frontier, float("-inf"), dist)
    fr, i = frontier, 0
    while i < n and bool(fr.any()):
        _, touched = edgemap_reduce(g, fr, dist, monoid="min", mode=mode, plan=plan)
        newly = touched & (dist > float("-inf"))
        dist = torch.where(fr | newly, float("-inf"), dist)
        fr, i = newly, i + 1
        count_round("bellman_ford")
    return dist, has_neg_cycle


def widest_path(g: GraphLike, src: int, *, mode: str = "auto", plan=None):
    """Single-source widest path (the max-min path semiring), Bellman-Ford
    style.  Returns width float32[n]: -inf where unreachable, +inf at the
    source."""
    if plan is not None:
        g = plan.prepare(g)
    src = int(src)
    width0 = torch.full((g.n,), float("-inf"), dtype=torch.float32, device=g.device)
    width0[src] = float("inf")
    width, _ = _relaxation_rounds(g, width0, src, monoid="max", map_fn=_bottleneck,
                                  algorithm="widest_path", mode=mode, plan=plan)
    return width


def _betweenness_levels(g: GraphLike, src: int, *, mode: str = "auto", plan=None):
    """Brandes' forward pass: ``(level int32[n], sigma float32[n], max_lvl)``,
    the BFS levels from ``src`` (-1 unreached), the shortest-path counts
    (sum monoid), and the number of rounds run."""
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    src = int(src)
    level = torch.full((n,), UNVISITED, dtype=torch.int32, device=dev)
    level[src] = 0
    sigma = torch.zeros(n, dtype=torch.float32, device=dev)
    sigma[src] = 1.0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[src] = True
    lvl = 0
    while lvl < n and bool(frontier.any()):
        cand, touched = edgemap_reduce(g, frontier, sigma, monoid="sum", mode=mode,
                                       plan=plan)
        newly = touched & (level == UNVISITED)
        sigma = torch.where(newly, cand, sigma)
        level = torch.where(newly, lvl + 1, level)
        frontier, lvl = newly, lvl + 1
        count_round("betweenness")
    return level, sigma, lvl


def betweenness(g: GraphLike, src: int, *, mode: str = "auto", plan=None):
    """Single-source betweenness centrality (Brandes forward/backward).

    Returns delta float32[n], the dependency scores from ``src``.  Forward:
    level-synchronous sigma accumulation (sum monoid).  Backward: the levels
    replayed in reverse, ``max_lvl`` rounds with no predicate read.  O(n)
    words of state: levels, sigma, delta."""
    if plan is not None:
        g = plan.prepare(g)
    level, sigma, max_lvl = _betweenness_levels(g, src, mode=mode, plan=plan)
    delta = torch.zeros(g.n, dtype=torch.float32, device=g.device)
    for lvl in range(max_lvl, 0, -1):
        upper = level == lvl  # vertices one level deeper
        y = torch.where(sigma > 0, (1.0 + delta) / sigma.clamp(min=1e-30), 0.0)
        y = torch.where(upper, y, 0.0)
        s, _ = edgemap_reduce(g, upper, y, monoid="sum", mode=mode, plan=plan)
        delta = torch.where(level == lvl - 1, sigma * s, delta)
        count_round("betweenness")
    delta[int(src)] = 0.0
    return delta


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
    independent.  The state lives on ``g.device``: pass the graph the
    cohort runs on (a plan's prepared graph: on a process plan, the rank's
    shard on its device)."""
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
    equal its single-query ``bfs`` / ``wbfs`` run.  The round's own tensors
    go where the prepared graph computes, with ``state``."""
    if plan is not None:
        g = plan.prepare(g)
    n, dev = g.n, g.device
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
