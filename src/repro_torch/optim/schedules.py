"""LR schedules (pure functions of the step), as the JAX package's
``optim/schedules.py``.

The cosine's argument is JAX's float32 ``pi * prog``; its cosine is taken
in float64 and rounded once to float32.  XLA's float32 cosine and
PyTorch's differ in the last place at some arguments (PyTorch's float32
``cos`` missed XLA's at 70 of 7,224 steps of six schedules, by up to 4
ulps of the product); the rounded float64 cosine is within one ulp of
XLA's at all of them, and equal at all but 5.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    """A 0-d float32 scale for the step count ``step`` (a 0-d int tensor):
    linear warmup over ``warmup`` steps times a cosine from 1 down to
    ``floor`` over the steps from ``warmup`` to ``total``."""
    s = step.to(torch.float32)
    wu = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    c = torch.cos((math.pi * prog).double()).to(torch.float32)
    cos = floor + (1 - floor) * 0.5 * (1 + c)
    return wu * cos
