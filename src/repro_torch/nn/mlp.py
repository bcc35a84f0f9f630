"""Feed-forward blocks: SwiGLU (the dense LMs: LLaMA/Mistral/Qwen style) and
the plain two-layer MLP of the GNNs (``mlp2``)."""
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp2(params: dict, x: torch.Tensor, act=gelu) -> torch.Tensor:
    """``act(x @ w1 + b1) @ w2 + b2``, the activation in float32 and cast
    back to ``x.dtype``; a tree without ``b1`` / ``b2`` has no biases."""
    h = act((x @ params["w1"] + params.get("b1", 0)).float()).to(x.dtype)
    return h @ params["w2"] + params.get("b2", 0)


def mlp2_specs(d_in: int, d_hidden: int, d_out: int, bias: bool = True) -> dict:
    """``{leaf: (shape, init)}`` of ``init_mlp2``: normal weights times
    1/sqrt(fan-in), zero biases (the JAX package's shapes and scales)."""
    p = {"w1": ((d_in, d_hidden), d_in ** -0.5), "w2": ((d_hidden, d_out), d_hidden ** -0.5)}
    if bias:
        p["b1"] = ((d_hidden,), "zeros")
        p["b2"] = ((d_out,), "zeros")
    return p


def mlp2_axes() -> dict:
    """Logical axis names of ``mlp2``'s leaves (the hidden axis named)."""
    return {"w1": (None, "hidden"), "b1": ("hidden",), "w2": ("hidden", None), "b2": (None,)}


def init_from_specs(specs, *, generator: torch.Generator, dtype=torch.float32, device=None):
    """A parameter tree drawn from ``generator`` leaf by leaf in the walk
    order of ``specs`` (dicts by key, lists in order), each leaf
    ``(shape, init)``: ``init`` a normal draw's scale or ``"zeros"``."""
    if isinstance(specs, dict):
        return {k: init_from_specs(v, generator=generator, dtype=dtype, device=device)
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [init_from_specs(v, generator=generator, dtype=dtype, device=device)
                for v in specs]
    shape, init = specs
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    return draw_normal(shape, init, generator=generator, dtype=dtype, device=device)


def init_mlp2(d_in: int, d_hidden: int, d_out: int, *, generator: torch.Generator,
              dtype=torch.float32, bias: bool = True, device=None) -> dict:
    """``mlp2`` weights drawn from ``generator`` (not a JAX key's numbers:
    the parity tests carry JAX's weights over)."""
    return init_from_specs(mlp2_specs(d_in, d_hidden, d_out, bias), generator=generator,
                           dtype=dtype, device=device)
