"""Covering problems (§4.3.3) — MIS, maximal matching, graph coloring,
approximate set cover.

Maximal matching and set cover exercise the graphFilter (§4.2): logically
deleted edges are bit-cleared by ``pack_vertices`` (the ``filter_pack``
kernel on the card), never rewritten in the read-only CSR.

The JAX package's ``lax.while_loop`` rounds are Python loops here, with
the same round caps; each round reads its loop condition on the host.  The
two filter users count their rounds in
``sage_algorithm_rounds_total{algorithm=...}``, one ``filter_pack``
launch each (and one more up front for set cover).  MIS and
set cover rank vertices by a random permutation of 0..n-1: ``priorities=``
takes one drawn elsewhere (the parity tests pass the JAX package's
``jax.random.permutation``), else it is drawn with ``torch.randperm`` from
``generator``.
"""
from __future__ import annotations

import torch

from ..core.edgemap import edgemap_reduce
from ..core.graph_filter import make_filter, pack_vertices, unpack_word_bits
from ..core.primitives import INF_I32, segment_reduce, take_fill
from ..obs import get_registry

MASK32 = 0xFFFFFFFF


def count_round(algorithm: str) -> None:
    """One round of ``algorithm``, in ``sage_algorithm_rounds_total``."""
    get_registry().counter(
        "sage_algorithm_rounds_total", "rounds run by the round-loop algorithms",
        labels=("algorithm",),
    ).inc(algorithm=algorithm)


def _priorities(n: int, device, priorities, generator) -> torch.Tensor:
    """int32[n] vertex priorities: ``priorities`` if given, else a
    ``torch.randperm`` drawn from ``generator``."""
    if priorities is None:
        gdev = "cpu" if generator is None else generator.device
        priorities = torch.randperm(n, generator=generator, device=gdev)
    p = torch.as_tensor(priorities).to(device=device, dtype=torch.int32)
    if tuple(p.shape) != (n,):
        raise ValueError(f"priorities must have shape ({n},), got {tuple(p.shape)}")
    return p


def _mulmod32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a · c mod 2^32`` for int64 ``a`` in [0, 2^32) and 0 ≤ c < 2^32,
    in two 16-bit halves of ``c`` so that no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


# ----------------------------------------------------------------------
def mis(g, generator: torch.Generator | None = None, *, priorities=None):
    """Maximal independent set (random-priority rounds, [17]).
    Returns in_set bool[n]."""
    n, dev = g.n, g.device
    pri = _priorities(n, dev, priorities, generator)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    undecided = torch.ones(n, dtype=torch.bool, device=dev)
    in_set = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool(undecided.any()):
        x = torch.where(undecided, pri, INF_I32)
        nbr_min, _ = edgemap_reduce(g, undecided, x, monoid="min", mode="auto")
        winners = undecided & (pri < nbr_min)
        # remove winners' neighbors
        hit, _ = edgemap_reduce(g, winners, ones, monoid="max", mode="auto")
        losers = undecided & (hit > 0) & ~winners
        undecided = undecided & ~winners & ~losers
        in_set = in_set | winners
    return in_set


# ----------------------------------------------------------------------
def maximal_matching(g):
    """Maximal matching via handshake rounds over the graphFilter.

    Returns partner int32[n] (-1 if unmatched).  Each round: every vertex
    proposes to its min-priority live incident edge's other endpoint; mutual
    proposals match; edges touching matched vertices are *filtered* (bits
    cleared, one ``filter_pack`` launch a round) — the CSR is never written
    (§4.2, Table 1 'Filter' rows).  The edge priority is the JAX package's
    uint32 hash of (min endpoint, max endpoint, round), computed in int64
    with every product reduced mod 2^32, so both packages match the same
    edges.
    """
    n, dev = g.n, g.device
    f = make_filter(g)
    src, dst = g.edge_src, g.edge_dst
    umin = torch.minimum(src, dst).to(torch.int64)
    umax = torch.maximum(src, dst).to(torch.int64)
    pair_hash = (_mulmod32(umin, 2654435761) + _mulmod32(umax, 40503)) & MASK32
    del umin, umax
    big = INF_I32
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    all_v = torch.ones(n, dtype=torch.bool, device=dev)
    partner = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rnd = 0
    while rnd < n and bool(f.num_active_edges > 0):
        count_round("maximal_matching")
        active = unpack_word_bits(f.bits).reshape(-1)
        h = (pair_hash + (rnd * 97 & MASK32)) & MASK32
        h = _mulmod32(h ^ (h >> 15), 2246822519)
        pri = (h >> 1).to(torch.int32)  # same for both directions
        del h
        pv = torch.where(active, pri, big)
        ids_d = torch.where(active, dst, n)
        minpri = segment_reduce(pv, ids_d, n + 1, "min")[:n]
        # candidate partner: min other-endpoint among min-priority edges
        at_min = active & (pri == take_fill(minpri, dst, big))
        cand = segment_reduce(torch.where(at_min, src, n), ids_d, n + 1, "min")[:n]
        prop = torch.where(minpri < big, cand, -1)
        mutual = (prop >= 0) & (prop[prop.clamp(min=0).long()] == ids)
        partner = torch.where(mutual & (partner < 0), prop, partner)
        matched = partner >= 0
        keep = ~take_fill(matched, src, True) & ~take_fill(matched, dst, True)
        f = pack_vertices(g, f, all_v, keep)
        rnd += 1
    return partner


# ----------------------------------------------------------------------
def coloring(g, *, num_colors: int = 256):
    """Greedy (Δ+1)-coloring, Jones–Plassmann with largest-degree-first
    priorities.  Returns color int32[n].

    The smallest-available-color (MEX) search marks forbidden colors in an
    (n+1, C) table (one byte an entry; the JAX package adds int32 counts)
    and takes the first free slot with ``argmax``, which returns the first
    maximal index, as ``jnp.argmax`` does.
    """
    n, C = g.n, num_colors
    dev = g.device
    deg = g.degrees
    src, dst, valid = g.edge_src, g.edge_dst, g.edge_valid
    deg_s = take_fill(deg, src, 0)
    deg_d = take_fill(deg, dst, 0)
    src_higher = (deg_s > deg_d) | ((deg_s == deg_d) & (src < dst))
    del deg_s, deg_d
    dst_ids = torch.where(valid, dst, n)
    color = torch.full((n,), -1, dtype=torch.int32, device=dev)
    while True:
        uncolored = color < 0
        blocked_e = valid & take_fill(uncolored, src, False) & src_higher
        has_higher = segment_reduce(blocked_e, dst_ids, n + 1, "or")[:n]
        ready = uncolored & ~has_higher
        # forbidden colors of colored neighbors; every other slot lands in row n
        col_s = take_fill(color, src, -1)
        contrib = valid & (col_s >= 0)
        cell = torch.where(contrib, dst, n).to(torch.int64) * C + col_s.clamp(0, C - 1)
        forb = torch.zeros((n + 1) * C, dtype=torch.uint8, device=dev)
        forb.index_fill_(0, cell, 1)
        free = (forb.view(n + 1, C)[:n] == 0).to(torch.uint8)
        mex = torch.argmax(free, dim=-1).to(torch.int32)
        color = torch.where(ready, mex, color)
        if not bool((color < 0).any()):
            return color


# ----------------------------------------------------------------------
def set_cover(
    g,
    sets_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    eps: float = 0.5,
    plan=None,
    priorities=None,
):
    """(1+ε)-style parallel greedy set cover over a bipartite graph.

    ``sets_mask[v]`` marks set-vertices; their neighbors are elements.
    Returns in_cover bool[n].  Bucketing by ⌈log_{1+ε} coverage⌉ (App. B);
    winners are resolved MaNIS-style with random priorities; covered
    elements are packed out of the graphFilter, one ``filter_pack`` launch
    up front and one a round.

    The two filtered edgeMaps per round go through ``edgemap_reduce`` in
    ``dense`` mode with the filter's packed words as ``edge_active``.
    Buckets and thresholds are float32, in the JAX package's order:
    ``log(1+ε)`` is rounded to float32 once on the host, and the bucket
    quotient divides by it as a device tensor (never a multiplication by
    its reciprocal).
    """
    n, dev = g.n, g.device
    sets_mask = sets_mask.to(device=dev, dtype=torch.bool)
    elems = ~sets_mask
    src, dst = g.edge_src, g.edge_dst
    all_v = torch.ones(n, dtype=torch.bool, device=dev)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    # only set↔element edges participate: pack the rest out up front
    bip = take_fill(sets_mask, src, False) ^ take_fill(sets_mask, dst, True)
    f = pack_vertices(g, make_filter(g), all_v, bip & g.edge_valid)
    pri = _priorities(n, dev, priorities, generator)
    # the edgeMaps run on the plan's placement (sharded on a mesh); the
    # filter packs and the win counts stay global passes over ``g``
    gs = g if plan is None else plan.prepare(g)
    log1e = torch.log(torch.tensor(1.0 + eps, dtype=torch.float32)).to(dev)

    def bucket_of(d):
        lg = torch.ceil(torch.log(d.clamp(min=1).to(torch.float32)) / log1e)
        return torch.where(d > 0, lg, -1.0).to(torch.int32)

    in_cover = torch.zeros(n, dtype=torch.bool, device=dev)
    covered = torch.zeros(n, dtype=torch.bool, device=dev)
    rnd = 0
    while rnd < 4 * n:
        coverable = elems & ~covered & (torch.where(elems, f.active_deg, 0) > 0)
        if not bool(coverable.any()):
            break
        count_round("set_cover")
        cov_deg = torch.where(sets_mask, f.active_deg, 0)
        b = bucket_of(cov_deg)
        top = b.max()
        cand = sets_mask & (b == top) & (cov_deg > 0) & ~in_cover
        # elements award themselves to their min-priority candidate
        # neighbor; a dst with no live candidate edge keeps the min
        # identity (INF), which never wins below
        win_pri, _ = edgemap_reduce(gs, cand, pri, monoid="min", edge_active=f.bits,
                                    mode="dense", plan=plan)
        active = unpack_word_bits(f.bits).reshape(-1)
        award_e = (active & take_fill(cand, src, False)
                   & take_fill(~covered, dst, False))
        pri_s = take_fill(pri, src, INF_I32)
        # edge is a win for the set if it holds the element's min priority
        won_e = award_e & (pri_s == take_fill(win_pri, dst, -1))
        wins = segment_reduce(won_e.to(torch.int32), torch.where(won_e, src, n), n + 1,
                              "sum")[:n]
        thresh = torch.clamp(
            torch.floor(torch.exp((top - 1).to(torch.float32) * log1e)), min=1.0
        ).to(torch.int32)
        chosen = cand & (wins >= torch.minimum(thresh, cov_deg))
        in_cover = in_cover | chosen
        # chosen sets cover all their currently-active elements: the
        # edgeMap's touched mask *is* "received ≥1 live contribution"
        _, cov_hit = edgemap_reduce(gs, chosen, ones, monoid="max", edge_active=f.bits,
                                    mode="dense", plan=plan)
        covered = covered | (elems & cov_hit)
        keep = ~take_fill(covered, src, False) & ~take_fill(covered, dst, False)
        f = pack_vertices(g, f, all_v, keep)
        rnd += 1
    return in_cover
