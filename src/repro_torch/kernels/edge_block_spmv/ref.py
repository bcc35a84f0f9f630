"""Plain PyTorch version of the uncompressed-block SpMV kernel.

``edge_block_spmv_ref`` has the signature of the kernel wrapper
(``edge_block_spmv.edge_block_spmv``) and of the JAX package's oracle, and
computes the same function with ordinary tensor ops: the CPU route runs it,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.  It
walks the graph one range of blocks at a time, so no more than one range of
gathered values is held at once.
"""
from __future__ import annotations

import torch

from ...core.graph_filter import unpack_word_bits
from ...core.primitives import segment_reduce
from ...tuning.defaults import DEFAULT_DENSE_RANGE_BLOCKS


def _range_sums(x, dst, w, bits, edge_active, n):
    act = unpack_word_bits(bits) if bits is not None else torch.ones_like(dst, dtype=torch.bool)
    if edge_active is not None:
        act = act & unpack_word_bits(edge_active)
    mask = (dst < n) & act
    safe = torch.where(mask, dst, 0).long()
    if x.dim() == 2:
        contrib = torch.where(mask[None], x[:, safe] * w[None], 0)   # (B, R, FB)
        return contrib.sum(dim=2, dtype=contrib.dtype).T.to(x.dtype)
    contrib = torch.where(mask, x[safe] * w, 0)
    return contrib.sum(dim=1, dtype=contrib.dtype).to(x.dtype)


def real_slot_counts(block_src, block_offsets, degrees, *, n: int, block_size: int):
    """int32[NB]: the real slots of each block.  A vertex's edges fill its
    blocks from the front, so block ``i`` of owner ``v = block_src[i]`` holds
    ``min(F_B, degrees[v] - (i - block_offsets[v]) * F_B)`` of them, and a
    block owned by the sentinel (``v >= n``) none; the kernel also clamps
    the count at 0."""
    NB = block_src.shape[0]
    owned = block_src < n
    v = torch.where(owned, block_src, 0).long()
    i = torch.arange(NB, dtype=torch.int64, device=block_src.device)
    c = degrees[v].long() - (i - block_offsets[v].long()) * block_size
    return torch.where(owned, c.clamp(0, block_size), 0).to(torch.int32)


def edge_block_spmv_ref(
    x: torch.Tensor,                            # (n_pad,) / (B, n_pad), float32 or int32
    block_dst: torch.Tensor,                    # (NB, FB) int32, sentinel n on padding
    block_w: torch.Tensor,                      # (NB, FB) float32
    bits: torch.Tensor | None,                  # (NB, FB//32) int32 graphFilter words
    edge_active: torch.Tensor | None = None,    # (NB, FB//32) int32 traversal mask
    *,
    n: int,
    owners=None,                                # (block_src, block_offsets, degrees)
) -> torch.Tensor:
    """Per-block partial sums ``out[b] = Σ_slot mask · w · x[dst]``, with
    ``mask = dst < n ∧ bits ∧ edge_active``: (NB,) or (NB, B) for a batch.
    int32 ``x`` is multiplied by the float weights, summed in float32 and
    truncated to int32, as the JAX package does.  ``owners`` tells the
    kernel which slots to read; this version masks by the targets alone, so
    its result does not depend on it."""
    NB = block_dst.shape[0]
    R = DEFAULT_DENSE_RANGE_BLOCKS
    return torch.cat([
        _range_sums(
            x, block_dst[lo : lo + R], block_w[lo : lo + R],
            None if bits is None else bits[lo : lo + R],
            None if edge_active is None else edge_active[lo : lo + R], n,
        )
        for lo in range(0, NB, R)
    ])


def spmv_vertex_ref(x, block_dst, block_w, bits, block_src, edge_active=None, *, n: int):
    """``edge_block_spmv_ref`` reduced onto the block owners: (n,) or (B, n)."""
    per_block = edge_block_spmv_ref(x, block_dst, block_w, bits, edge_active, n=n)
    out = segment_reduce(per_block, block_src, n + 1, "sum")[:n]
    return out.T if x.dim() == 2 else out
