"""Megatron's tensor parallelism over a ``ProcessMesh``'s ``model`` axes:
the compute that XLA's partitioner writes for the JAX package's LM under
``LM_RULES`` (heads, ff and vocab split over ``model``), written out.

  copy_to(x, mesh, axes)     — the entry of a column-parallel group: ``x``
                               itself; the backward sums the gradient over
                               ``axes`` (each rank's columns saw part of it)
  reduce_from(x, mesh, axes) — the exit of a row-parallel product: the
                               ranks' partials summed; the backward is the
                               identity (every rank's consumer is the same)
  vocab_lookup(rows, ids, lo, mesh, axes) — rows of a table split by rows
                               (the tied embedding over ``vocab``): the ids
                               in [lo, lo + len(rows)) looked up, the rest
                               zero rows, then ``reduce_from``
  vocab_cross_entropy(logits, targets, lo, mesh, axes) — the per-position
                               cross-entropy of logits whose columns are
                               split: lse - the target's logit, in float32

A replicated activation enters a group through ``copy_to`` and leaves it
through ``reduce_from``, so the residual stream stays the same on every rank
of ``axes``, bit for bit (an all-reduce hands every rank the same sum).
Not ``distributed.gnn``'s ``_AllReduceSum``: that one sums in both
directions, which is right for split edge lists and doubles every gradient
here, where the consumer of the sum is replicated.

The partials of a row-parallel product are summed in the activation dtype
(bf16 on the card): half the bytes of float32, at the cost of a second
rounding beside the one-device product's one.  Every function here is
called by every rank of ``axes`` in the same order; over axes of size 1 no
collective runs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .serving import all_reduce


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.mesh,
                          ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _parallel(mesh, axes) -> bool:
    return any(mesh.axis_size(a) > 1 for a in axes)


def copy_to(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``x``; its gradient summed over ``axes`` in the backward."""
    return _CopyTo.apply(x, mesh, axes) if _parallel(mesh, axes) else x


def reduce_from(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``x`` summed over ``axes``; its gradient passed through."""
    return _ReduceFrom.apply(x, mesh, axes) if _parallel(mesh, axes) else x


def vocab_lookup(rows: torch.Tensor, ids: torch.Tensor, lo: int, mesh,
                 axes: tuple) -> torch.Tensor:
    """``table[ids]`` for a table split by rows over ``axes``, ``rows`` this
    rank's rows [lo, lo + len(rows)): an id outside them reads a zero row,
    then one SUM over ``axes`` (``x + 0 = x``: the rows come back exactly)."""
    local = ids - lo
    inside = (local >= 0) & (local < rows.shape[0])
    out = rows[torch.where(inside, local, 0)]
    return reduce_from(torch.where(inside[..., None], out, torch.zeros_like(out)), mesh, axes)


class _VocabCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, lo, mesh, axes):
        parallel = _parallel(mesh, axes)
        top = logits.amax(dim=-1)
        if parallel:
            all_reduce(top, mesh, axes, dist.ReduceOp.MAX)
        local = targets - lo
        inside = (local >= 0) & (local < logits.shape[-1])
        at = torch.where(inside, local, 0)
        picked = torch.gather(logits, -1, at[..., None])[..., 0]
        sums = torch.stack([torch.sum(torch.exp(logits - top[..., None]), dim=-1),
                            torch.where(inside, picked, torch.zeros_like(picked))])
        if parallel:
            all_reduce(sums, mesh, axes)
        lse = torch.log(sums[0]) + top
        ctx.save_for_backward(logits, lse, at, inside)
        return lse - sums[1]

    @staticmethod
    def backward(ctx, grad):
        logits, lse, at, inside = ctx.saved_tensors
        g = torch.exp(logits - lse[..., None])
        g.scatter_add_(-1, at[..., None], -inside.to(g.dtype)[..., None])
        return g * grad[..., None], None, None, None, None


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, lo: int, mesh,
                        axes: tuple) -> torch.Tensor:
    """Per-position ``logsumexp(all logits) - logit[target]`` of float32
    ``logits`` (..., V_r), the columns [lo, lo + V_r) of the vocabulary split
    over ``axes``: one all-reduce MAX of the row maxima, one SUM of the
    exponentials' sums beside the target's logit (the owner's; 0 on the
    rest).  ``targets`` are the global ids; a negative one (masked) picks no
    column and the caller's mask zeroes its term.  The backward is local:
    softmax minus the one-hot of the rank's columns, times the gradient."""
    return _VocabCrossEntropy.apply(logits, targets.long(), lo, mesh, axes)
