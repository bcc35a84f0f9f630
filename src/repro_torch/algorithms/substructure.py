"""Substructure problems (§4.3.4) — k-core, approximate densest subgraph,
triangle counting.

k-core / densest subgraph use the dense-histogram peeling discipline
(segment-sum of removed-neighbor counts).  Triangle counting orients edges
low→high degree *through a graphFilter* (the CSR itself is never
re-ordered) and intersects adjacency lists in fixed-size chunks, so the
peak intermediate is O(chunk·Δ⁺) words — the §4.2.3 blocked-decode scheme.
Everything stays on the graph's device; the loop conditions are read on
the host.
"""
from __future__ import annotations

import torch

from ..core.bucketing import NULL_BUCKET, make_buckets
from ..core.edgemap import edgemap_reduce
from ..core.graph_filter import GraphFilter, pack_bits
from ..core.primitives import INF_I32


# ----------------------------------------------------------------------
def kcore(g, *, plan=None):
    """Coreness of every vertex — Julienne-style bucketed peeling (App. B).

    ``bucket_of[v]`` is v's current induced degree (retired once peeled);
    each round extracts the minimum non-empty bucket, peels every vertex at
    or below the running core number k, and subtracts the removed-neighbor
    histogram (an edgeMap with the sum monoid).  Returns core int32[n].
    ``plan`` routes the histogram edgeMaps through the planner's knobs.
    """
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    deg = g.degrees
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    core = torch.zeros(n, dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    while bool(alive.any()):
        mn, _, _ = make_buckets(torch.where(alive, deg, NULL_BUCKET)).next_bucket()
        k = torch.maximum(k, mn)
        peel = alive & (deg <= k)
        core = torch.where(peel, k, core)
        cnt, _ = edgemap_reduce(g, peel, ones, monoid="sum", mode="auto", plan=plan)
        deg = torch.clamp(deg - cnt, min=0)
        alive = alive & ~peel
    return core


# ----------------------------------------------------------------------
def densest_subgraph(g, *, eps: float = 0.001):
    """(2+ε)-approximate densest subgraph (Charikar peeling, parallel).
    Returns (best_mask bool[n], best_density float32 0-dim tensor); the
    density is float32 throughout, as in the JAX package."""
    n, dev = g.n, g.device
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    thresh = torch.tensor(2.0 * (1.0 + eps), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    deg = g.degrees
    best_mask = alive
    best_rho = torch.zeros((), dtype=torch.float32, device=dev)
    while True:
        n_act = alive.sum().to(torch.float32)
        m_act = torch.where(alive, deg, 0).sum().to(torch.float32)  # 2|E(S)|
        rho = torch.where(n_act > 0, m_act / 2.0 / torch.clamp(n_act, min=1.0), 0.0)
        best_mask = torch.where(rho > best_rho, alive, best_mask)
        best_rho = torch.maximum(best_rho, rho)
        remove = alive & (deg.to(torch.float32) <= thresh * rho)
        # guard: always remove at least the min-degree vertices
        if not bool(remove.any()):
            remove = alive & (deg == torch.where(alive, deg, INF_I32).min())
        cnt, _ = edgemap_reduce(g, remove, ones, monoid="sum", mode="auto")
        deg = torch.clamp(deg - cnt, min=0)
        alive = alive & ~remove
        if not bool(alive.any()):
            return best_mask, best_rho


# ----------------------------------------------------------------------
def orientation_filter(g) -> tuple[GraphFilter, torch.Tensor]:
    """Low→high degree orientation expressed as a graphFilter (§4.3.4):
    the 'directed' graph is the immutable CSR viewed through bits that keep
    only slots with rank(src) < rank(dst).  Returns (filter, keep bool[NB*F_B]);
    no vertex is dirty, as in a fresh ``make_filter``."""
    n, dev = g.n, g.device
    src = g.edge_src.to(torch.int64)
    dst = g.edge_dst.to(torch.int64)
    valid = dst < n
    rank = torch.cat([
        g.degrees.to(torch.int64) * (n + 1) + torch.arange(n, device=dev),
        torch.tensor([torch.iinfo(torch.int64).max], device=dev),
    ])
    keep = valid & (rank[src.clamp(max=n)] < rank[dst.clamp(max=n)])
    f = GraphFilter(
        bits=pack_bits(keep.reshape(g.num_blocks, g.block_size)),
        active_deg=torch.bincount(src[keep], minlength=n).to(torch.int32),
        dirty=torch.zeros(n, dtype=torch.bool, device=dev),
        n=n,
        num_blocks=g.num_blocks,
        block_size=g.block_size,
    )
    return f, keep


def triangle_count(g, *, chunk: int = 16384) -> int:
    """Exact global triangle count.  Orients via ``orientation_filter`` and
    intersects N⁺(u)/N⁺(v) per directed edge in chunks (blocked decode):
    a batched ``torch.searchsorted`` (side left) of each u-row in its v-row
    of the (n+1, dmax) oriented adjacency, int32 on the graph's device."""
    n, dev = g.n, g.device
    _, keep = orientation_filter(g)
    us = g.edge_src[keep].to(torch.int64)
    vs = g.edge_dst[keep].to(torch.int64)
    e = us.shape[0]
    if e == 0:
        return 0
    # oriented padded adjacency, rows sorted ascending
    deg_or = torch.bincount(us, minlength=n)
    dmax = max(1, int(deg_or.max()))
    SEN = 2**31 - 2
    adj = torch.full((n + 1, dmax), SEN, dtype=torch.int32, device=dev)
    order = torch.argsort(us * (n + 1) + vs)
    uo, vo = us[order], vs[order]
    starts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(deg_or, dim=0)
    adj[uo, torch.arange(e, device=dev) - starts[uo]] = vo.to(torch.int32)
    del order, uo, vo, starts
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, e, chunk):
        au = adj[us[s : s + chunk]]  # (C, D)
        av = adj[vs[s : s + chunk]]
        pos = torch.searchsorted(av, au).clamp_(0, dmax - 1)
        hit = (torch.gather(av, 1, pos) == au) & (au < SEN)
        total += hit.sum()
    return int(total)
