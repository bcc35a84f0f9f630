"""Rotary position embeddings (RoPE), interleaved as in the JAX package.

The rotation pairs ``x[..., ::2]`` with ``x[..., 1::2]`` and stacks the two
rotated halves back on the last axis.  That is not the rotate-half layout
of the Hugging Face Qwen code: the port follows the JAX package.
"""
from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S).  The angles
    are float32; ``x``'s halves promote to float32 against them, and the
    result is cast back to ``x.dtype``."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)
    ang = positions.float()[..., None] * inv  # (..., S, D/2)
    if x.dim() == ang.dim() + 1:  # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    out = torch.stack([xr1, xr2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
