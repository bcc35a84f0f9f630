"""Eigenvector problems (§4.3.5) — PageRank.

One iteration is a single dense edgeMap with the sum monoid; the per-vertex
aggregation is a parallel segment-reduce.  O(P_it·m) work.
"""
from __future__ import annotations

import torch

from ..core.backend import GraphLike
from ..core.edgemap import edgemap_reduce, edgemap_reduce_batched
from ..core.plan import round_loop


def pagerank(
    g: GraphLike,
    *,
    damping: float = 0.85,
    eps: float = 1e-6,
    max_iters: int = 100,
    plan=None,
):
    """Returns (pr float32[n], iters int)."""
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    deg = g.degrees.clamp(min=1).to(torch.float32)
    dangling = g.degrees == 0
    full_mask = torch.ones(n, dtype=torch.bool, device=dev)
    pr0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)

    def sweep_inputs(state):
        pr, _, _ = state
        return state, full_mask, torch.where(dangling, 0.0, pr / deg)

    def epilogue(state, s, _touched):
        pr, it, _ = state
        dangling_mass = torch.where(dangling, pr, 0.0).sum()
        new = (1.0 - damping) / n + damping * (s + dangling_mass / n)
        return new, it + 1, (new - pr).abs().sum()

    def cond(state):
        _, it, err = state
        return it < max_iters and bool(err > eps)

    pr, iters, _ = round_loop(
        g, (pr0, 0, torch.tensor(float("inf"), device=dev)),
        sweep_inputs=sweep_inputs, epilogue=epilogue, cond_fn=cond,
        monoid="sum", plan=plan, mode="dense",
    )
    return pr, iters


def pagerank_iteration(g: GraphLike, pr: torch.Tensor, *, damping: float = 0.85, plan=None):
    """A single PageRank iteration (Table 1 'PageRank Iteration' row)."""
    n = g.n
    if plan is not None:
        g = plan.prepare(g)
    deg = g.degrees.clamp(min=1).to(torch.float32)
    dangling = g.degrees == 0
    contrib = torch.where(dangling, 0.0, pr / deg)
    s, _ = edgemap_reduce(
        g, torch.ones(n, dtype=torch.bool, device=g.device), contrib,
        monoid="sum", mode="dense", plan=plan,
    )
    dangling_mass = torch.where(dangling, pr, 0.0).sum()
    return (1.0 - damping) / n + damping * (s + dangling_mass / n)


def pagerank_iteration_batched(
    g: GraphLike, prs: torch.Tensor, *, damping: float = 0.85, plan=None
):
    """B PageRank iterations over B score vectors in one dense edge sweep.

    ``prs`` is float32[B, n]; returns float32[B, n], each row equal to
    ``pagerank_iteration`` on that row alone up to summation order."""
    n = g.n
    if plan is not None:
        g = plan.prepare(g)
    B = prs.shape[0]
    deg = g.degrees.clamp(min=1).to(torch.float32)
    dangling = g.degrees == 0
    contrib = torch.where(dangling[None, :], 0.0, prs / deg[None, :])
    s, _ = edgemap_reduce_batched(
        g, torch.ones((B, n), dtype=torch.bool, device=g.device), contrib,
        monoid="sum", mode="dense", plan=plan,
    )
    dangling_mass = torch.where(dangling[None, :], prs, 0.0).sum(dim=1)
    return (1.0 - damping) / n + damping * (s + dangling_mass[:, None] / n)
