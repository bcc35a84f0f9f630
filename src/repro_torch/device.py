"""Where the port's tensors live, and which kernel route they take.

Every entry point that creates graph or vertex state takes ``device``.  The
default is the card: ``None`` means ``"cuda"``, and asking for ``cuda`` on a
host without one raises instead of quietly running on the CPU.  The CPU is
used only when the caller names it (the parity tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a ``cuda`` device must exist, else RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch route"
        )
    return dev


def kernel_route(device) -> str:
    """The kernel route of tensors on ``device``: ``"cuda"`` (hand-written
    kernels) for a CUDA device, ``"torch"`` (plain versions) for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda"
    if dev.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel route for device {dev}")
