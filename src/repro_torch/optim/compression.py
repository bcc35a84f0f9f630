"""int8 gradient compression with a per-tensor float32 scale, as the JAX
package's ``optim/compression.py``: a 4x smaller payload for the slow axis
of a mesh.  ``compressed_psum`` is the int8 mean over one axis of a
``ProcessMesh`` (quantize, all-reduce in int32, dequantize).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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


def compressed_psum(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """The int8-compressed mean of ``x`` over the ranks of ``mesh``'s axis
    ``axis_name`` (its group ``mesh.axis_groups[axis_name]``), in the JAX
    package's order: the scale ``max(max|x|, 1e-12) / 127`` all-reduced with
    MAX, so every rank quantizes and dequantizes alike; ``x / scale``
    rounded half to even and clipped to [-127, 127]; the int8 payload
    summed in int32 (no overflow below 2^24 ranks); the sum times the scale
    divided by the axis size in float32, cast to ``x``'s dtype.  Every rank
    of the axis calls it."""
    group = mesh.axis_groups[axis_name]
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = torch.tensor(float(mesh.axis_size(axis_name)), dtype=torch.float32, device=x.device)
    return (total.float() * scale / n).to(x.dtype)


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
