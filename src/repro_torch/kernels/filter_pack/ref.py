"""Plain PyTorch version of the graphFilter pack kernel.

``filter_pack_ref`` has the signature of the kernel wrapper
(``filter_pack.filter_pack_words``) and of the JAX package's oracle, and
computes the same function with ordinary tensor ops: the CPU route runs
it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from ...core.graph_filter import pack_bits
from ...core.primitives import popcount32


def filter_pack_ref(bits, keep, subset):
    """``bits`` int32 (NB, W) filter words, ``keep`` bool (NB, 32·W),
    ``subset`` bool (NB,) → ``(new_bits int32 (NB, W), count int32 (NB,))``.

    ``keep`` is packed little-endian into words and ANDed into the rows
    whose ``subset`` holds; ``count`` is each new row's popcount."""
    new_bits = torch.where(subset[:, None], bits & pack_bits(keep), bits)
    return new_bits, popcount32(new_bits).sum(dim=1, dtype=torch.int32)
