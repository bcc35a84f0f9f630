"""graphFilter (§4.2) — a bit-packed, mutable *view* over the immutable CSR.

The CSR edge arrays (large memory) are never written.  All mutation happens
in this structure, which costs ``m`` bits + O(n) words:

* ``bits``        int32[NB, F_B/32] — one bit per edge slot (1 = active),
  little-endian within each word; int32 is a bit-view of the uint32 words
  of the JAX package, so ``(w >> s) & 1`` reads the same bits
* ``active_deg``  int32[n]          — live degree per vertex
* ``dirty``       bool[n]           — vertices whose edges changed this round

The filter composes with either backend (``CSRGraph`` or ``CompressedCSR``):
the block size is the compression block size (§4.2.1), so the bits line up
1:1 with decoded compressed blocks.
"""
from __future__ import annotations

import dataclasses

import torch

WORD = 32


@dataclasses.dataclass(frozen=True)
class GraphFilter:
    bits: torch.Tensor        # int32[NB, F_B//32]
    active_deg: torch.Tensor  # int32[n]
    dirty: torch.Tensor       # bool[n]
    n: int
    num_blocks: int
    block_size: int


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def unpack_word_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32[..., W] → bool[..., W*32], little-endian within each word.

    The canonical bit order for every graphFilter consumer (edgeMap, the
    kernels and their plain versions) — change it here and in ``pack_bits``
    together."""
    opened = ((bits.to(torch.int32)[..., :, None] >> _shifts(bits.device)) & 1).bool()
    return opened.reshape(bits.shape[:-1] + (bits.shape[-1] * WORD,))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[NB, F_B] → int32[NB, F_B//32] (bit-view of the uint32 words)."""
    nb, fb = mask.shape
    m3 = mask.reshape(nb, fb // WORD, WORD).to(torch.int64)
    words = (m3 << _shifts(mask.device).to(torch.int64)).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def make_filter(g) -> GraphFilter:
    """makeFilter (§4.2.2): all real edges start active."""
    mask = g.edge_valid.reshape(g.num_blocks, g.block_size)
    return GraphFilter(
        bits=pack_bits(mask),
        active_deg=g.degrees,
        dirty=torch.zeros(g.n, dtype=torch.bool, device=g.degrees.device),
        n=g.n,
        num_blocks=g.num_blocks,
        block_size=g.block_size,
    )


def edge_active_words(edge_active, block_size: int) -> torch.Tensor:
    """Normalize any edge-activity form to packed int32[NB, F_B/32] words.

    Accepts a ``GraphFilter`` (its ``bits``), packed int32 (NB, F_B/32)
    words (passed through), or a bool edge-slot mask, flat [NB*F_B] or
    [NB, F_B] (packed here)."""
    if isinstance(edge_active, GraphFilter):
        return edge_active.bits
    a = edge_active
    if a.dtype == torch.int32:
        if a.dim() != 2 or a.shape[-1] != block_size // WORD:
            raise ValueError(
                f"packed edge_active must be (NB, {block_size // WORD}) int32, "
                f"got {tuple(a.shape)}"
            )
        return a
    if a.dtype == torch.bool:
        return pack_bits(a.reshape(-1, block_size))
    raise TypeError(
        f"edge_active must be a GraphFilter, packed int32 words, or a bool "
        f"slot mask, got dtype {a.dtype}"
    )
