"""Fully sharded data parallelism over a ``ProcessMesh``'s batch axes: the
parameter gathers that XLA's partitioner writes for the JAX package's LM
under ``LM_RULES`` (``embed`` over ``data``), written out one layer at a
time.

  gathered(anchor, block, sink, spec, mesh, axes, keep=()) — ``block``
                        all-gathered over the batch ``axes`` it splits over
                        and over ``keep``; in the backward its float32
                        gradient is summed over ``axes`` into ``sink``
                        (``sum_grad``) and cut to the rank's part over
                        ``keep``, whose ranks compute the same gradient
  held(anchor, full, sink) — a tensor gathered once a step (the tied
                        embedding): ``full`` itself, its float32 gradient
                        added to ``sink`` (``full``'s shape), which the step
                        sums into the block once (``step_scatter``)
  sum_grad(g, spec, mesh, axes, keep=()) — a gathered leaf's gradient summed
                        over the batch ``axes`` into the rank's block: one
                        reduce-scatter an axis ``spec`` splits, one
                        all-reduce over the rest (``pod`` under ``LM_RULES``,
                        where ``embed`` splits over ``data`` alone); a leaf
                        that no batch axis splits is left to the caller
  gather_rows(h, sizes, mesh, axes) — a microbatch's rows from every rank
                        of ``axes`` (rank r holds ``sizes[r]``, possibly
                        none), in order; the backward sums the gradient over
                        ``axes`` and keeps the rank's rows

The gradients go to ``sink`` and not to ``block``: a block is bf16 on the
card, and the step accumulates its microbatches in float32, as the
one-device step does.  ``anchor`` is a 0-d tensor that requires grad and
ties each gather into the autograd graph; it receives no gradient.  A
gather inside a checkpointed layer is run again by the recompute and never
saved, so a rank holds one gathered layer at a time.  Over axes of size 1
no collective runs: ``gathered`` then hands back the block itself.
"""
from __future__ import annotations

import torch

from .serving import all_reduce, gather_parts
from .shardings import PartitionSpec, gather_over, reduce_scatter_blocks, shard_block, spec_axes


def _moving(spec, mesh, axes) -> tuple:
    """The axes of ``axes`` that ``spec`` splits over more than one rank."""
    return tuple(a for e in spec for a in spec_axes(e) if a in axes and mesh.axis_size(a) > 1)


def _only(spec, axes) -> PartitionSpec:
    """``spec`` with every mesh axis outside ``axes`` dropped."""
    return PartitionSpec(*[tuple(a for a in spec_axes(e) if a in axes) or None for e in spec])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, block, sink, spec, mesh, axes, keep):
        ctx.args = (sink, spec, mesh, axes, keep)
        moving = _moving(spec, mesh, axes + keep)
        return gather_over(block, spec, mesh, moving) if moving else block.view_as(block)

    @staticmethod
    def backward(ctx, grad):
        sink, spec, mesh, axes, keep = ctx.args
        sink.add_(sum_grad(grad.float(), spec, mesh, axes, keep))
        return (None,) * 7


def sum_grad(g: torch.Tensor, spec, mesh, axes: tuple, keep: tuple = ()) -> torch.Tensor:
    """The gradient ``g`` of a leaf gathered over the batch ``axes`` that
    ``spec`` splits (and over ``keep``) as the rank's block: reduce-scattered
    over those axes, all-reduced over the other batch ``axes``, whose ranks
    hold other rows, and cut over ``keep``.  A leaf that no batch axis of
    more than one rank splits comes back unsummed (cut over ``keep``): the
    step sums those leaves together."""
    split = _moving(spec, mesh, axes)
    if not split:
        return shard_block(g, _only(spec, keep), mesh) if _moving(spec, mesh, keep) else g
    g = reduce_scatter_blocks(g, spec, mesh, split, keep=keep)
    rest = tuple(a for a in axes if a not in split and mesh.axis_size(a) > 1)
    return all_reduce(g.contiguous(), mesh, rest) if rest else g


def gathered(anchor: torch.Tensor, block: torch.Tensor, sink: torch.Tensor, spec, mesh,
             axes: tuple, keep: tuple = ()) -> torch.Tensor:
    """``block`` (the rank's block under ``spec``) gathered over the batch
    ``axes`` it splits and over ``keep``; the backward adds its float32
    gradient, summed over ``axes`` and cut over ``keep`` (``sum_grad``), to
    ``sink`` (float32, the block's shape)."""
    return _Gather.apply(anchor, block, sink, spec, mesh, tuple(axes), tuple(keep))


class _Held(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, full, sink):
        ctx.sink = sink
        return full.view_as(full)

    @staticmethod
    def backward(ctx, grad):
        ctx.sink.add_(grad.float())
        return None, None, None


def held(anchor: torch.Tensor, full: torch.Tensor, sink: torch.Tensor) -> torch.Tensor:
    """``full``; its float32 gradient added to ``sink`` in the backward."""
    return _Held.apply(anchor, full, sink)


def step_gather(block: torch.Tensor, spec, mesh, axes: tuple) -> torch.Tensor:
    """``block`` gathered over ``axes`` once a step, with no gradient."""
    moving = _moving(spec, mesh, axes)
    return gather_over(block, spec, mesh, moving) if moving else block


def step_scatter(sink: torch.Tensor, spec, mesh, axes: tuple) -> torch.Tensor:
    """A ``held`` tensor's float32 gradient summed over the batch ``axes``
    into the rank's block (``sum_grad``): once a step."""
    return sum_grad(sink, spec, mesh, axes)


class _Rows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, sizes, mesh, axes):
        r = mesh.shard_index(axes)
        ctx.args = (mesh, axes, sum(sizes[:r]), h.shape[0])
        top = max(sizes)
        pad = torch.cat([h, h.new_zeros((top - h.shape[0],) + tuple(h.shape[1:]))])
        parts = gather_parts(pad, mesh, axes)
        return torch.cat([parts[i, :n] for i, n in enumerate(sizes)])

    @staticmethod
    def backward(ctx, grad):
        mesh, axes, lo, n = ctx.args
        g = all_reduce(grad.clone(memory_format=torch.contiguous_format), mesh, axes)
        return g[lo:lo + n], None, None, None


def gather_rows(h: torch.Tensor, sizes: list, mesh, axes: tuple) -> torch.Tensor:
    """Every rank's rows of a microbatch over ``axes`` in rank order (rank
    r holds ``sizes[r]`` rows, the rank's own ``h``); its gradient summed
    over ``axes``, the rank's rows kept.  One rank: ``h`` itself."""
    if len(sizes) == 1:
        return h
    return _Rows.apply(h, list(sizes), mesh, axes)
