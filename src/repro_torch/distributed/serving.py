"""Serving state sharded over a ``ProcessMesh``: the pieces that XLA's
partitioner writes for the JAX package's serving cells, written out.

  seq_block(mesh, axes, n)                  — this rank's range [lo, hi) of a
                                              dimension of n split over ``axes``
  merge_attention(out, lse, mesh, axes)     — single-token attention partials of
                                              a cache sharded along its rows,
                                              merged across the ranks
                                              (``merge_partials``' arithmetic)
  local_rows(block, ids, lo)                — rows of a row-sharded table at
                                              global ids, zero where another
                                              rank owns the id (no collective)
  sharded_rows(block, ids, lo, mesh, axes)  — the same rows from every rank's
                                              block: ``take_rows`` on the table
  merge_topk(values, indices, k, mesh, axes) — the ranks' top-k merged

A dimension split over ``axes`` is cut into equal contiguous parts, the
rank's part the row-major digits of its coordinates on those axes, as
``shardings.shard_block`` places a block.  Every function here is called by
every rank of the mesh, in the same order as its other collectives; a
collective over an axis of size 1 is skipped.  The gathers move bytes
(``shardings._all_gather_dim``), so values and int32 ids travel in one
tensor, bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..kernels.embedding_bag import embedding_bag_sums
from .shardings import _all_gather_dim


def _parts(mesh, axes) -> int:
    return math.prod(mesh.axis_size(a) for a in axes)


def seq_block(mesh, axes: tuple, n: int) -> tuple[int, int]:
    """This rank's range [lo, hi) of a dimension of ``n`` split evenly over
    ``axes``: a cache's positions along ``cache_seq``, and equally a
    table's rows or a candidate list.  Raises on an uneven split."""
    parts = _parts(mesh, axes)
    if n % parts:
        raise ValueError(f"a dimension of {n} does not split evenly over {parts} ranks "
                         f"(mesh axes {axes})")
    size = n // parts
    lo = mesh.shard_index(tuple(axes)) * size
    return lo, lo + size


def gather_parts(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """(R, *t.shape): every rank's ``t`` over ``axes``, R their product, in
    the order of ``seq_block``'s parts (the first axis the slowest)."""
    x = t.contiguous()[None]
    for a in reversed(axes):
        if mesh.axis_size(a) > 1:
            x = _all_gather_dim(x, 0, mesh.axis_groups[a], mesh.axis_size(a))
    return x


def all_reduce(t: torch.Tensor, mesh, axes: tuple, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place by ``op`` over ``axes``: one all-reduce an axis."""
    for a in axes:
        if mesh.axis_size(a) > 1:
            dist.all_reduce(t, op=op, group=mesh.axis_groups[a])
    return t


def all_reduce_sum(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``t`` summed in place over ``axes``: one all-reduce an axis."""
    return all_reduce(t, mesh, axes)


def merge_attention(out: torch.Tensor, lse: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """The single-token attention over a cache sharded along its rows over
    ``axes``: every rank's float32 partial ``out`` (B, Hq, D) and its
    log-sum-exp ``lse`` (B, Hq) are all-gathered (one tensor, (B, Hq, D + 1))
    and merged in float32, ``sum_r exp(lse_r - M) out_r / sum_r exp(lse_r -
    M)`` with M the largest ``lse_r``.  A rank with no rows has lse -inf and
    weight 0.  Returns float32 (B, Hq, D): the caller rounds once."""
    if _parts(mesh, axes) == 1:
        return out.float()
    parts = gather_parts(torch.cat([out.float(), lse.float()[..., None]], dim=-1), mesh, axes)
    return merge_partials(parts[..., :-1], parts[..., -1])


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """``merge_attention``'s arithmetic on partials stacked along dim 0:
    outs (R, B, Hq, D), lses (R, B, Hq), float32 → (B, Hq, D)."""
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)                            # -inf → 0
    return (w[..., None] * outs).sum(dim=0) / torch.clamp_min(w.sum(dim=0), 1e-30)[..., None]


def local_rows(block: torch.Tensor, ids: torch.Tensor, lo: int, n_global: int) -> torch.Tensor:
    """``ids.shape + (D,)``: the rows of ``block`` (global rows [lo, lo +
    len(block)) of a table of ``n_global`` rows) at the global ``ids``,
    zero rows for ids outside the block.  Ids in [-n_global, -1] wrap to
    ``id + n_global`` first, as ``take_rows`` wraps them on the whole table;
    an id outside the block goes to kernel 5's padding (-1), never shifted
    into it.  Each id is a bag of one with weight 1: a row comes back
    exactly."""
    rows, D = block.shape
    flat = ids.reshape(-1, 1).long()
    flat = torch.where(flat < 0, flat + n_global, flat) - lo
    flat = torch.where((flat >= 0) & (flat < rows), flat, -1).to(torch.int32)
    return embedding_bag_sums(block, flat.contiguous()).reshape(*ids.shape, D)


def sharded_rows(block: torch.Tensor, ids: torch.Tensor, lo: int, mesh,
                 axes: tuple) -> torch.Tensor:
    """``take_rows(table, ids)`` for a table whose rows are split over
    ``axes``, ``block`` this rank's rows from ``lo``: each rank looks up the
    ids it owns with kernel 5 and zero rows for the rest, then one SUM
    all-reduce.  Bit for bit ``take_rows`` on the whole table (``x + 0 =
    x``).  Every rank of an ``axes`` line passes the same ``ids``."""
    n_global = block.shape[0] * _parts(mesh, axes)
    return all_reduce_sum(local_rows(block, ids, lo, n_global), mesh, axes)


def merge_topk(values: torch.Tensor, indices: torch.Tensor, k: int, mesh,
               axes: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of a row-sharded catalog's scores: ``values`` (B, k')
    and ``indices`` (B, k') int32 are this rank's local top-k with global
    ids, best first.  One all-gather of both over ``axes`` (ids as their
    bytes, beside the values), then the top ``k`` of the (B, k' R)
    candidates, best first; blocks are disjoint, so no id comes twice.
    Returns ``(values, indices int32)``."""
    if _parts(mesh, axes) == 1:
        return values[:, :k], indices[:, :k].to(torch.int32)
    packed = torch.stack([values.float(), indices.to(torch.int32).view(torch.float32)])
    parts = gather_parts(packed, mesh, axes)             # (R, 2, B, k')
    vals = parts[:, 0].permute(1, 0, 2).reshape(values.shape[0], -1)
    ids = parts[:, 1].contiguous().view(torch.int32).permute(1, 0, 2).reshape(vals.shape)
    top, at = torch.topk(vals, k, dim=-1, largest=True, sorted=True)
    return top, torch.gather(ids, 1, at)
