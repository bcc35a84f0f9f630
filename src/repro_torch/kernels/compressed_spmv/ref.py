"""Plain PyTorch version of the frontier-sparse compressed-block kernel.

``compressed_chunked_spmv_ref`` has the signature of the kernel wrapper
(``compressed_spmv.compressed_chunked_spmv``) and computes the same function
with ordinary tensor ops: the CPU route runs it, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card.  Like the kernel, it decodes blocks
holding ESCAPE deltas wrong on purpose (the callers in ``ops.py`` patch
them), and it widens one chunk of deltas at a time, never the graph.
"""
from __future__ import annotations

import torch

from ...core.graph_filter import unpack_word_bits


def compressed_chunked_spmv_ref(
    x: torch.Tensor | None,        # (n_pad,) / (B, n_pad) for "sums"; None for "decode"
    ids: torch.Tensor,             # (C,) — compacted live block ids (pad: >= NB)
    block_first: torch.Tensor,     # (NB,) int32
    deltas: torch.Tensor,          # (NB, FB) int16 bit-view of the uint16 codes
    valid_count: torch.Tensor,     # (NB,) int16 bit-view
    bits: torch.Tensor | None = None,           # (NB, FB//32) int32 graphFilter words
    edge_active: torch.Tensor | None = None,    # (NB, FB//32) int32 traversal mask
    block_weights: torch.Tensor | None = None,  # (NB, FB) float32
    *,
    n: int,
    emit: str = "sums",
):
    """``emit="decode"`` → (dst (C, FB) int32, w (C, FB) float32);
    ``emit="sums"`` → (C,) for a 1-D ``x``, (C, B) for a (B, n_pad) ``x``."""
    if emit not in ("sums", "decode"):
        raise ValueError(f"emit must be 'sums' or 'decode', got {emit!r}")
    NB, FB = deltas.shape
    ids = ids.long()
    pad = (ids < 0) | (ids >= NB)
    rows = torch.where(pad, 0, ids)
    d = deltas[rows].to(torch.int32) & 0xFFFF
    d[:, 0] = 0
    dst = block_first[rows][:, None] + torch.cumsum(d, dim=1, dtype=torch.int32)
    vc = torch.where(pad, 0, valid_count[rows].to(torch.int32) & 0xFFFF)
    lane = torch.arange(FB, device=deltas.device)
    mask = lane[None, :] < vc[:, None]
    if bits is not None:
        mask = mask & unpack_word_bits(bits[rows])
    if edge_active is not None:
        mask = mask & unpack_word_bits(edge_active[rows])
    live = mask & (dst < n)

    if block_weights is not None:
        w = torch.where(pad[:, None], 0.0, block_weights[rows])
    else:
        w = None
    if emit == "decode":
        if w is None:
            w = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
        return torch.where(live, dst, n), w

    safe = torch.where(live, dst, 0).long()
    if x.dim() == 2:
        xv = x[:, safe]                                   # (B, C, FB)
        if w is not None:
            xv = xv * w[None]
        contrib = torch.where(mask[None], xv, 0)
        return contrib.sum(dim=2, dtype=contrib.dtype).T.to(x.dtype)
    xv = x[safe]
    if w is not None:
        xv = xv * w
    contrib = torch.where(mask, xv, 0)
    return contrib.sum(dim=1, dtype=contrib.dtype).to(x.dtype)
