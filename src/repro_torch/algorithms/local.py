"""Local algorithms (paper §3.2 Applicability): personalized PageRank.

Forward-push PPR (Andersen–Chung–Lang): keep an estimate p and a residual
r; while some r[v] ≥ ε·deg(v), push α·r[v] into p[v] and spread
(1−α)·r[v]/deg(v) to v's neighbors.  The frontier-synchronous variant
below pushes every above-threshold vertex each round.  The push state is
O(n) words and each round is one edgeMap of float32 sums over the active
frontier; the loops are Python loops over a host-read predicate.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.backend import GraphLike
from ..core.edgemap import edgemap_reduce, edgemap_reduce_batched


def personalized_pagerank(
    g: GraphLike,
    src: int,
    *,
    alpha: float = 0.15,
    eps: float = 1e-6,
    max_rounds: int = 200,
    mode: str = "auto",
    plan=None,
):
    """Returns (p float32[n], residual float32[n], rounds int).

    Guarantee (ACL): |p[v] − π(v)| ≤ ε·deg(v) at termination."""
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    deg = g.degrees.clamp(min=1).to(torch.float32)
    thresh = eps * deg
    p = torch.zeros(n, dtype=torch.float32, device=dev)
    r = torch.zeros(n, dtype=torch.float32, device=dev)
    r[int(src)] = 1.0
    rounds = 0
    while rounds < max_rounds:
        active = r >= thresh
        if not bool(active.any()):
            break
        pushed = torch.where(active, r, 0.0)
        p = p + alpha * pushed
        # spread (1-α)·pushed/deg along out-edges
        contrib = torch.where(active, (1.0 - alpha) * pushed / deg, 0.0)
        s, _ = edgemap_reduce(g, active, contrib, monoid="sum", mode=mode, plan=plan)
        r = torch.where(active, 0.0, r) + s
        rounds += 1
    return p, r, rounds


def personalized_pagerank_batched(
    g: GraphLike,
    sources,
    *,
    alpha: float = 0.15,
    eps: float = 1e-6,
    max_rounds: int = 200,
    mode: str = "auto",
    plan=None,
):
    """B concurrent PPR queries through one shared push sweep per round.

    ``sources`` is int[B]; returns (p float32[B, n], residual float32[B, n],
    rounds int32[B]).  A query that has converged (or hit ``max_rounds``)
    is gated out of the frontier, so its rows freeze and its ``rounds``
    stops: each row runs its single-query recurrence."""
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    srcs = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    B = srcs.shape[0]
    deg = g.degrees.clamp(min=1).to(torch.float32)
    thresh = (eps * deg)[None, :]
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    p = torch.zeros((B, n), dtype=torch.float32, device=dev)
    r = (ids[None, :] == srcs[:, None]).to(torch.float32)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    while True:
        above = r >= thresh
        # per-query run gate: the single-query loop's condition, so a
        # converged or capped query runs no body from here on
        run = above.any(dim=1) & (rounds < max_rounds)
        if not bool(run.any()):
            break
        active = above & run[:, None]
        pushed = torch.where(active, r, 0.0)
        p = p + alpha * pushed
        contrib = torch.where(active, (1.0 - alpha) * pushed / deg[None, :], 0.0)
        s, _ = edgemap_reduce_batched(g, active, contrib, monoid="sum", mode=mode, plan=plan)
        r = torch.where(active, 0.0, r) + s
        rounds = rounds + run.to(torch.int32)
    return p, r, rounds


def ppr_matrix_oracle(g: GraphLike, src: int, *, alpha: float = 0.15, iters: int = 2000):
    """Dense power-iteration oracle in float64 numpy: π = α·e_s + (1−α)·Wᵀπ
    (for tests)."""
    n = g.n
    s = g.edge_src.cpu().numpy()
    d = g.edge_dst.cpu().numpy()
    valid = d < n
    deg = np.maximum(np.bincount(s[valid], minlength=n), 1)
    pi = np.zeros(n)
    pi[src] = 1.0
    e = np.zeros(n)
    e[src] = 1.0
    for _ in range(iters):
        agg = np.zeros(n)
        np.add.at(agg, d[valid], (pi / deg)[s[valid]])
        new = alpha * e + (1 - alpha) * agg
        if np.abs(new - pi).sum() < 1e-12:
            break
        pi = new
    return pi
