"""int8 gradient compression with a per-tensor float32 scale, as the JAX
package's ``optim/compression.py``: a 4x smaller payload for the slow axis
of a mesh.

Not here: ``compressed_psum`` (quantize, all-reduce in int32, dequantize),
which waits for the ``torch.distributed`` combine (``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from .tree import tree_map


def quantize_int8(x: torch.Tensor):
    """``(q, scale)``: ``x / scale`` rounded half to even and clipped to
    [-127, 127] as int8, ``scale = max(max|x|, 1e-12) / 127`` (0-d float32)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads):
    """Each leaf as its ``(q, scale)``."""
    return tree_map(quantize_int8, grads)


def decompress_tree(qtree, dtype=torch.float32):
    """The inverse of ``compress_tree``: each ``(q, scale)`` pair dequantized."""
    if isinstance(qtree, tuple) and len(qtree) == 2 and all(
            isinstance(x, torch.Tensor) for x in qtree):
        return dequantize_int8(qtree[0], qtree[1], dtype)
    if isinstance(qtree, dict):
        return {k: decompress_tree(v, dtype) for k, v in qtree.items()}
    return type(qtree)(decompress_tree(v, dtype) for v in qtree)
