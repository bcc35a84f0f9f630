"""Feed-forward block of the dense LMs: SwiGLU (LLaMA/Mistral/Qwen style)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """params: w_gate (d, f), w_up (d, f), w_down (f, d).  The gate's SiLU
    runs in float32 and is cast back to ``x.dtype``."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def swiglu_specs(d: int, f: int) -> dict:
    """``{leaf: (shape, scale)}``: normal weights times 1/sqrt(fan-in), the
    JAX package's ``init_swiglu`` shapes and scales."""
    return {
        "w_gate": ((d, f), d ** -0.5),
        "w_up": ((d, f), d ** -0.5),
        "w_down": ((f, d), f ** -0.5),
    }


def draw_normal(shape, scale, *, generator, dtype, device) -> torch.Tensor:
    """A standard normal draw in float32, times ``scale``, cast to ``dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)  # in place: one float32 temporary a leaf


def init_swiglu(d: int, f: int, *, generator: torch.Generator, dtype=torch.float32,
                device=None) -> dict:
    """SwiGLU weights drawn from ``generator`` (a torch generator does not
    give a JAX key's numbers; the parity tests carry JAX's weights over)."""
    return {name: draw_normal(shape, scale, generator=generator, dtype=dtype, device=device)
            for name, (shape, scale) in swiglu_specs(d, f).items()}
