"""Public wrapper around the graphFilter pack kernel."""
from __future__ import annotations

import torch

from ...core.graph_filter import GraphFilter, _recount
from ...core.primitives import take_fill
from .filter_pack import filter_pack_words


def filter_pack(g, f: GraphFilter, subset_mask: torch.Tensor,
                keep_pred: torch.Tensor) -> GraphFilter:
    """Kernel-backed ``core.graph_filter.pack_vertices`` without the dirty
    tracking: ``dirty`` comes back unchanged, as in the JAX package's op.

    ``keep_pred`` is bool[NB*F_B] or bool[NB, F_B]; the per-block counts of
    the kernel are segment-summed by block owner into ``active_deg``."""
    keep = keep_pred.reshape(g.num_blocks, g.block_size).contiguous()
    if keep.data_ptr() % 16:  # a view into a larger tensor: the kernel loads 16 B
        keep = keep.clone()
    subset_blk = take_fill(subset_mask, g.block_src, False)
    bits, count = filter_pack_words(f.bits, keep, subset_blk)
    return GraphFilter(
        bits=bits,
        active_deg=_recount(g, count),
        dirty=f.dirty,
        n=f.n,
        num_blocks=f.num_blocks,
        block_size=f.block_size,
    )
