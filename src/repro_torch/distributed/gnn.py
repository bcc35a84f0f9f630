"""The GNN aggregation split over a ``ProcessMesh``: the combine that XLA's
partitioner writes for the JAX package's GNN cells under ``GNN_RULES``,
written out.

  edge_slice(mesh, axes, n_items) — this rank's range of an edge (or
                                    triplet) list split over ``axes`` and
                                    the combines across those ranks, as a
                                    ``models.gnn.aggregate.EdgeSlice``

The graph is split as the paper splits it: the edge lists, read-only, in
equal contiguous ranges (``seq_block``), and the O(n) vertex state whole on
every rank.  A layer gathers from whole node state, reduces over its own
edges into all n segments, and combines:

* a sum is one all-reduce SUM, an autograd function whose backward is an
  all-reduce SUM of the incoming gradient (each rank's partial feeds every
  rank's copy of the sum);
* a max or min is one all-reduce MAX / MIN of the local extremum (an empty
  segment -inf / +inf); its backward counts the elements on every rank
  that tie for the global extremum (one all-reduce SUM of the counts
  beside the incoming gradients) and gives each tied element gradient /
  count, as one device splits a tie;
* a count, or the edge softmax's max (detached, as JAX's
  ``stop_gradient``), is an all-reduce with no gradient.

Every rank runs the same layers on the same shapes, so every rank issues
the same collectives in the same order, the backward's too.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..models.gnn.aggregate import EdgeSlice
from .serving import all_reduce, seq_block

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class _AllReduceSum(torch.autograd.Function):
    """``t`` summed over ``axes``; the backward sums the gradient so."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t.clone(memory_format=torch.contiguous_format), mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.mesh,
                          ctx.axes), None, None


class _SegmentExtremum(torch.autograd.Function):
    """``local`` (this rank's ``amax`` / ``amin`` of ``vals`` by ``seg``)
    combined over every rank; the gradient split among the global ties."""

    @staticmethod
    def forward(ctx, vals, seg, local, reduce, mesh, axes):
        out = all_reduce(local.clone(), mesh, axes, _OPS["max" if reduce == "amax" else "min"])
        ctx.save_for_backward(vals, seg, out)
        ctx.mesh, ctx.axes = mesh, axes
        return out

    @staticmethod
    def backward(ctx, grad):
        vals, seg, out = ctx.saved_tensors
        idx = seg.reshape((-1,) + (1,) * (vals.ndim - 1)).expand(vals.shape)
        tie = vals == out.gather(0, idx)
        both = torch.stack([grad, torch.zeros_like(out).scatter_add_(0, idx, tie.to(out.dtype))])
        grad, count = all_reduce(both, ctx.mesh, ctx.axes)
        share = (grad / count).gather(0, idx)      # a non-empty segment's count is >= 1
        return torch.where(tie, share, torch.zeros_like(share)), None, None, None, None, None


def edge_slice(mesh, axes: tuple, n_items: int) -> EdgeSlice:
    """This rank's ``EdgeSlice`` of a list of ``n_items`` edges (or
    triplets) split evenly over the mesh ``axes``: its range
    (``seq_block``; an uneven split raises) and the combines over those
    axes.  Over axes of size 1 the range is the whole list and no
    collective runs."""
    lo, hi = seq_block(mesh, axes, n_items)
    return EdgeSlice(
        lo, hi, math.prod(mesh.axis_size(a) for a in axes),
        sum=lambda t: _AllReduceSum.apply(t, mesh, axes),
        extremum=lambda vals, seg, local, reduce: _SegmentExtremum.apply(
            vals, seg, local, reduce, mesh, axes),
        reduce=lambda t, op: all_reduce(t, mesh, axes, _OPS[op]))
