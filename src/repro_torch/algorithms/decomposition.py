"""Connectivity problems (§4.3.2) — LDD, connectivity, multi-source BFS,
spanning forest, O(k)-spanner and biconnectivity.

``ldd`` is the Miller–Peng–Xu low-diameter decomposition with quantized
shifts: a BFS from every center at once, with min-cluster-id tie-breaks, in
which vertex v wakes as a center at round ⌊δ_max − δ_v⌋ if still
unclustered.  ``connectivity`` seeds the min-label fixpoint with LDD's
clusters and canonicalizes each component to its min vertex id, so its
labels do not depend on the shifts drawn.

Biconnectivity follows Tarjan–Vishkin over a BFS spanning forest: an
Euler tour ranked by pointer jumping gives preorder numbers and subtree
sizes, low/high climb the BFS levels, and the auxiliary graph's
connectivity runs through edge-slot masks on the original graph, so no
O(m)-word auxiliary structure is built.  The spanner and the
biconnectivity's slot arithmetic sort stably by the same keys as the JAX
package's ``lexsort``, so every pick and label equals it.

The loops are Python loops over a host-read predicate, one read a round;
``ldd`` and ``_min_label_prop`` count their rounds in
``sage_algorithm_rounds_total{algorithm="ldd"}`` and
``{algorithm="min_label_prop"}``.
"""
from __future__ import annotations

import torch

from ..core.backend import GraphLike
from ..core.edgemap import edgemap_reduce
from ..core.primitives import INF_I32, segment_reduce, take_fill
from .covering import count_round

UNVISITED = -1


def ldd_shift(n: int, beta: float, generator: torch.Generator) -> torch.Tensor:
    """The per-vertex shifts δ_v ~ Exp(β), float32[n] on ``generator``'s
    device, clamped at 2·ln(n+1)/β."""
    e = torch.empty(n, dtype=torch.float32, device=generator.device)
    e.exponential_(generator=generator)
    shift = e / beta
    cap = torch.tensor(float(n + 1), dtype=torch.float32).log() * 2.0 / beta
    return torch.minimum(shift, cap.to(shift.device))


def ldd(
    g: GraphLike,
    beta: float,
    generator: torch.Generator | None = None,
    *,
    shift: torch.Tensor | None = None,
    mode: str = "auto",
    plan=None,
):
    """(O(β), O(log n / β)) decomposition.  Returns cluster int32[n]
    (cluster id == center vertex id).

    The shifts are drawn from ``generator`` (``ldd_shift``), or passed as
    ``shift`` (float32[n], already divided by β and clamped); the clusters
    are a function of the shifts alone.
    """
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    if shift is None:
        if generator is None:
            raise ValueError("ldd needs a generator or a shift")
        shift = ldd_shift(n, beta, generator)
    shift = torch.as_tensor(shift, dtype=torch.float32).to(dev)
    if shift.shape != (n,):
        raise ValueError(f"shift must be float32[{n}], got {tuple(shift.shape)}")
    start_round = torch.floor(shift.max() - shift).to(torch.int32)
    max_round = int(start_round.max())
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    cluster = torch.full((n,), UNVISITED, dtype=torch.int32, device=dev)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    r = 0
    # every vertex self-starts by max_round; + n rounds of expansion
    while r < max_round + n + 2 and bool(frontier.any() | (cluster == UNVISITED).any()):
        cand, touched = edgemap_reduce(g, frontier, cluster, monoid="min", mode=mode,
                                       plan=plan)
        newly = touched & (cluster == UNVISITED)
        cluster = torch.where(newly, cand, cluster)
        wake = (cluster == UNVISITED) & (start_round <= r)
        cluster = torch.where(wake, ids, cluster)
        frontier = newly | wake
        r += 1
        count_round("ldd")
    return cluster


def _min_label_prop(
    g: GraphLike,
    labels0: torch.Tensor,
    *,
    edge_active=None,
    vertex_mask: torch.Tensor | None = None,
    plan=None,
):
    """Hook-and-compress min-label fixpoint; labels must be vertex ids.

    Every round is a dense pass (all vertices push), then two pointer
    jumps."""
    n = g.n
    if plan is not None:
        g = plan.prepare(g)
    full_mask = (torch.ones(n, dtype=torch.bool, device=g.device)
                 if vertex_mask is None else vertex_mask)
    labels = labels0
    while True:
        nbr, _ = edgemap_reduce(g, full_mask, labels, monoid="min",
                                edge_active=edge_active, mode="dense", plan=plan)
        new = torch.minimum(labels, nbr)
        if vertex_mask is not None:
            new = torch.where(full_mask, new, labels)
        new = new[new.long()]  # compress (pointer jump)
        new = new[new.long()]
        changed = bool((new != labels).any())
        labels = new
        count_round("min_label_prop")
        if not changed:
            return labels


def connectivity(
    g: GraphLike,
    generator: torch.Generator | None = None,
    *,
    use_ldd: bool = True,
    shift: torch.Tensor | None = None,
    plan=None,
):
    """Connected components; label = min vertex id of the component.

    With ``use_ldd`` and a ``generator`` (or an LDD ``shift``), one LDD with
    β = 0.2 seeds the labels with cluster ids; otherwise every vertex starts
    as its own label.  The labels equal whatever the seed."""
    n = g.n
    if plan is not None:
        g = plan.prepare(g)
    if use_ldd and (generator is not None or shift is not None):
        labels0 = ldd(g, 0.2, generator, shift=shift, plan=plan)
    else:
        labels0 = torch.arange(n, dtype=torch.int32, device=g.device)
    labels = _min_label_prop(g, labels0, plan=plan)
    # canonicalize: component representative = min vertex id
    rep = segment_reduce(torch.arange(n, dtype=torch.int32, device=g.device), labels, n,
                         "min")
    return rep[labels.long()]


def multi_source_bfs(g: GraphLike, roots_mask: torch.Tensor, *, mode: str = "auto",
                     plan=None):
    """BFS forest from all roots at once.  Returns (parents, levels);
    parents[root] = root.  The B=1 row of ``bfs_batched``, so on the card a
    ``sparse_streamed`` plan runs one fused round a level."""
    from .traversal import bfs_batched

    parents, levels = bfs_batched(g, roots_mask[None, :], mode=mode, plan=plan)
    return parents[0], levels[0]


def spanning_forest(g: GraphLike, generator: torch.Generator | None = None, *,
                    shift: torch.Tensor | None = None):
    """Spanning forest.  Returns (parents int32[n], labels int32[n]); the
    forest edges are {(v, parents[v]) : parents[v] != v}, each tree rooted at
    its component's min vertex id.  A ``generator`` or an LDD ``shift``
    seeds connectivity with LDD clusters; the result is the same either way."""
    labels = connectivity(g, generator, shift=shift,
                          use_ldd=generator is not None or shift is not None)
    roots = labels == torch.arange(g.n, dtype=torch.int32, device=g.device)
    parents, _ = multi_source_bfs(g, roots)
    return parents, labels


def _stable_pair_order(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """The permutation of ``jnp.lexsort((hi, lo))``: by lo, then hi, ties in
    index order; lo and hi lie in [0, n]."""
    key = lo.to(torch.int64) * (n + 1) + hi.to(torch.int64)
    return torch.sort(key, stable=True).indices


def spanner(g: GraphLike, k: int, generator: torch.Generator | None = None, *,
            shift: torch.Tensor | None = None, inter_cap_factor: int = 8):
    """O(k)-spanner (Miller et al., §C.1).  Returns (edge_mask bool[slots], ok).

    The intra-cluster BFS-tree edges of an LDD with β = ln(n+1) / (2k), and
    one representative edge (the first slot in index order) per adjacent
    cluster pair, symmetrized.  Only the compacted inter-cluster slot list
    is materialized, capped at ``inter_cap_factor · n``: ``ok`` is False when
    it overflowed (the §C.2 restart signal).  The LDD shift is drawn from
    ``generator`` or passed as ``shift``."""
    n, dev = g.n, g.device
    src, dst, valid = g.edge_src, g.edge_dst, g.edge_valid
    slots = src.shape[0]
    # ln(n+1) in float32, as the JAX package computes it
    beta = float(torch.tensor(float(n + 1), dtype=torch.float32).log()) / (2.0 * k)
    cluster = ldd(g, beta, generator, shift=shift)

    # intra-cluster BFS tree
    same = (take_fill(cluster, src, -1) == take_fill(cluster, dst, -2)) & valid
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    centers = cluster == ids
    parents = torch.where(centers, ids, UNVISITED)
    frontier, r = centers, 0
    while r < n and bool(frontier.any()):
        cand, touched = edgemap_reduce(g, frontier, ids, monoid="min", edge_active=same,
                                       mode="auto")
        newly = touched & (parents == UNVISITED)
        parents = torch.where(newly, cand, parents)
        frontier, r = newly, r + 1
    del same
    tree_slot = ((take_fill(parents, dst, -1) == src)
                 | (take_fill(parents, src, -1) == dst)) & valid

    # one edge per adjacent cluster pair (compact → stable sort → first of run)
    cu = take_fill(cluster, src, 0)
    cv = take_fill(cluster, dst, 0)
    hit = torch.nonzero(valid & (cu != cv)).reshape(-1)
    cap = inter_cap_factor * n
    count = int(hit.shape[0])
    ok = count <= cap
    idx = torch.full((cap,), slots, dtype=torch.int64, device=dev)
    idx[: min(count, cap)] = hit[:cap]
    del hit
    a, b = take_fill(cu, idx, n), take_fill(cv, idx, n)
    del cu, cv
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    order = _stable_pair_order(lo, hi, n)
    lo_s, hi_s, idx_s = lo[order], hi[order], idx[order]
    first = torch.ones_like(lo_s, dtype=torch.bool)
    first[1:] = (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])
    first &= lo_s < n
    pick = torch.zeros(slots + 1, dtype=torch.bool, device=dev)
    pick[torch.where(first, idx_s, slots)] = True
    return _symmetrize_slot_mask(g, tree_slot | pick[:slots]), ok


def _symmetrize_slot_mask(g: GraphLike, mask: torch.Tensor) -> torch.Tensor:
    """Make (u,v) selected ⟺ (v,u) selected: slots sorted stably by their
    undirected pair (min, max), each selection ORed across its run (a simple
    graph's runs hold at most its two directions)."""
    src, dst = g.edge_src, g.edge_dst
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    order = _stable_pair_order(lo, hi, g.n)
    lo_s, hi_s, m_s = lo[order], hi[order], mask[order]
    del lo, hi
    # neighbours in sorted order holding the same pair share their selection
    shared = (lo_s[1:] == lo_s[:-1]) & (hi_s[1:] == hi_s[:-1]) & (m_s[1:] | m_s[:-1])
    m_sym = m_s.clone()
    m_sym[1:] |= shared
    m_sym[:-1] |= shared
    out = torch.zeros_like(mask)
    out[order] = m_sym
    return out & g.edge_valid


def _euler_tour_preorder(g: GraphLike, parents: torch.Tensor, labels: torch.Tensor):
    """Preorder numbers and subtree sizes of a rooted forest, int32[n] each,
    via an Euler tour ranked by pointer jumping.  ``labels`` names each
    vertex's root (its component's min vertex id).  All state O(n) words."""
    n, dev = g.n, g.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    is_root = parents == ids

    # children sorted by id: first_child = min child; next_sibling via a sort
    child_parent = torch.where(is_root, n, parents)  # roots are nobody's child
    first_child = segment_reduce(torch.where(is_root, INF_I32, ids), child_parent, n + 1,
                                 "min")[:n]
    has_child = first_child < INF_I32
    order = _stable_pair_order(child_parent, ids, n)  # non-roots grouped by parent
    sp = child_parent[order]
    same_next = torch.zeros(n, dtype=torch.bool, device=dev)
    same_next[:-1] = (sp[1:] == sp[:-1]) & (sp[1:] < n)
    nxt = torch.zeros(n, dtype=torch.int64, device=dev)
    nxt[:-1] = order[1:]
    next_sibling = torch.full((n,), -1, dtype=torch.int32, device=dev)
    next_sibling[order] = torch.where(same_next, nxt, -1).to(torch.int32)

    # tour nodes: enter(v) = v, exit(v) = n + v, the sentinel 2n
    sent = 2 * n
    enter_succ = torch.where(has_child, first_child, n + ids)
    exit_succ = torch.where(next_sibling >= 0, next_sibling,
                            torch.where(is_root, sent, n + parents))
    succ = torch.cat([enter_succ, exit_succ, enter_succ.new_full((1,), sent)]).long()
    suffix = torch.cat([torch.ones(n, dtype=torch.int32, device=dev),
                        torch.zeros(n + 1, dtype=torch.int32, device=dev)])
    # ceil(log2(2n + 1)) jumps reach the sentinel from every tour node
    for _ in range(max(1, (2 * n).bit_length())):
        suffix = suffix + suffix[succ]
        succ = succ[succ]
    suffix_enter, suffix_exit = suffix[:n], suffix[n : 2 * n]

    comp_root = labels.long()  # min-id root per component
    comp_total = suffix_enter[comp_root]
    pre_in_comp = comp_total - suffix_enter
    size = suffix_enter - suffix_exit
    comp_size = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce_(
        0, comp_root, comp_total, reduce="amax", include_self=True)
    base = torch.cumsum(comp_size, dim=0, dtype=torch.int32) - comp_size
    pre = base[comp_root] + pre_in_comp
    return pre.to(torch.int32), size.to(torch.int32)


def biconnectivity(g: GraphLike, generator: torch.Generator | None = None):
    """Per-edge-slot biconnected-component labels (int32[slots], -1 on
    padding).

    Tarjan–Vishkin over a BFS spanning forest (``generator`` is unused: the
    forest's connectivity runs without LDD, as in the JAX package): Euler-tour
    preorder and subtree sizes, low/high by level-wise upward propagation,
    then the auxiliary graph's connectivity through edge-slot masks."""
    del generator
    n, dev = g.n, g.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    labels = connectivity(g, use_ldd=False)
    parents, levels = multi_source_bfs(g, labels == ids)
    pre, size = _euler_tour_preorder(g, parents, labels)

    src, dst, valid = g.edge_src, g.edge_dst, g.edge_valid
    tree_sd = valid & (take_fill(parents, dst, -1) == src)  # src is dst's parent
    tree_ds = valid & (take_fill(parents, src, -1) == dst)
    nontree = valid & ~tree_sd & ~tree_ds

    # low/high: min/max preorder reachable via one nontree edge from the subtree
    everyone = torch.ones(n, dtype=torch.bool, device=dev)
    min_nt, _ = edgemap_reduce(g, everyone, pre, monoid="min", edge_active=nontree,
                               mode="dense")
    max_nt, _ = edgemap_reduce(g, everyone, pre, monoid="max", edge_active=nontree,
                               mode="dense")
    low, high = torch.minimum(pre, min_nt), torch.maximum(pre, max_nt)
    not_root = parents != ids
    for lvl in range(int(levels.max()), 0, -1):
        at = levels == lvl  # the children's level
        pids = torch.where(at & not_root, parents, n)
        cl = segment_reduce(torch.where(at, low, INF_I32), pids, n + 1, "min")[:n]
        ch = segment_reduce(torch.where(at, high, -1), pids, n + 1, "max")[:n]
        low, high = torch.minimum(low, cl), torch.maximum(high, ch)

    # auxiliary edges over the original slots: nontree edges between
    # unrelated vertices ...
    pre_s, pre_d = take_fill(pre, src, 0), take_fill(pre, dst, 0)
    size_s, size_d = take_fill(size, src, 0), take_fill(size, dst, 0)
    anc_sd = (pre_s <= pre_d) & (pre_d < pre_s + size_s)  # src an ancestor of dst
    anc_ds = (pre_d <= pre_s) & (pre_s < pre_d + size_d)
    aux_active = nontree & ~anc_sd & ~anc_ds
    del size_s, size_d, anc_sd, anc_ds, nontree
    # ... and tree edges whose child's subtree escapes its non-root parent
    pre_p, size_p = take_fill(pre, parents, 0), take_fill(size, parents, 0)
    esc = ((low < pre_p) | (high >= pre_p + size_p)) & not_root
    join_up = esc & ~(take_fill(parents, parents, -1) == parents)
    aux_active |= ((tree_sd & take_fill(join_up, dst, False))
                   | (tree_ds & take_fill(join_up, src, False)))
    aux_labels = _min_label_prop(g, ids, edge_active=aux_active)
    del aux_active

    # per-slot labels: the child endpoint of a tree edge, else the deeper one
    deeper = torch.where(pre_s > pre_d, src, dst)
    del pre_s, pre_d
    child = torch.where(tree_sd, dst, torch.where(tree_ds, src, deeper))
    return torch.where(valid, take_fill(aux_labels, child, -1), -1)
