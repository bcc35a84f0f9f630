"""Mixture-of-Experts FFN with sort-based (linear-memory) dispatch, as the
JAX package's ``nn/moe.py``.

Tokens are sorted by expert id (a stable sort over the flat assignments in
t·K + k order) and packed into an (E, C, d) capacity buffer; the experts'
SwiGLU runs as three batched products over it.  An assignment past its
expert's first C goes to the overflow bin E·C, which is sliced away: it
adds zero, and the gates are not renormalised.

Router: softmax over the selected top-k logits (DBRX/Mixtral convention).
The top k come from a stable descending sort, so equal logits pick the
lower expert id first, as ``lax.top_k`` does (``torch.topk`` promises no
order on ties).

C is a shape computed from T on the host, so the dispatch makes no host
sync and no tensor whose shape depends on the data.  The batched products
read every expert's weights whatever its occupancy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .mlp import draw_normal, swiglu, swiglu_specs


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_model: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25


def moe_specs(cfg: MoECfg) -> dict:
    """``{leaf: (shape, scale)}`` of ``init_moe``: normal weights times
    1/sqrt(d) for the router and the gate and up projections, 1/sqrt(f) for
    the down projection; the shared experts one SwiGLU of width
    ``n_shared * d_ff_expert``.  The JAX package's shapes and scales."""
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    specs = {
        "router": ((d, E), d ** -0.5),
        "w_gate": ((E, d, f), d ** -0.5),
        "w_up": ((E, d, f), d ** -0.5),
        "w_down": ((E, f, d), f ** -0.5),
    }
    if cfg.n_shared:
        specs["shared"] = swiglu_specs(d, cfg.n_shared * f)
    return specs


def init_moe(cfg: MoECfg, *, generator: torch.Generator, dtype=torch.float32,
             device=None) -> dict:
    """MoE weights drawn from ``generator`` (a torch generator does not give
    a JAX key's numbers; the parity tests carry JAX's weights over)."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, scale = spec
        return draw_normal(shape, scale, generator=generator, dtype=dtype, device=device)

    return make(moe_specs(cfg))


def capacity(cfg: MoECfg, T: int) -> int:
    """Slots an expert holds for T tokens: ``capacity_factor · K · T / E``
    truncated, plus one, rounded up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * cfg.top_k * T / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)


class MoERoute(NamedTuple):
    """The routing of T tokens.  ``topi`` (T, K) int64 expert ids, best
    first; ``gates`` (T, K) in the activation dtype; ``slot`` (T, K) the
    slot ``e * C + position`` of each assignment, E·C where it was dropped;
    ``token_of_slot`` (E·C,) the token in each slot, T where it is empty;
    ``keep`` (T, K) bool, the assignments that got a slot."""

    topi: torch.Tensor
    gates: torch.Tensor
    slot: torch.Tensor
    token_of_slot: torch.Tensor
    keep: torch.Tensor


def moe_route(params: dict, x: torch.Tensor, cfg: MoECfg) -> MoERoute:
    """x: (T, d) → the sort-based capacity dispatch of ``moe_ffn``."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, T)
    dev = x.device

    logits = (x @ params["router"]).float()                       # (T, E)
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :K], topi[:, :K]
    gates = torch.softmax(topv, dim=-1).to(x.dtype)

    flat_e = topi.reshape(-1)                                     # t·K + k order
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    se, order = torch.sort(flat_e, stable=True)
    st = flat_t[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - starts[se]
    keep = pos < C
    slot_sorted = torch.where(keep, se * C + pos, E * C)          # E·C: the overflow bin

    token_of_slot = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    token_of_slot.scatter_(0, slot_sorted, st)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    slot = slot.reshape(T, K)
    return MoERoute(topi, gates, slot, token_of_slot[:E * C], slot < E * C)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoECfg) -> torch.Tensor:
    """x: (T, d) → (T, d).  Sort-based capacity dispatch."""
    T, d = x.shape
    E = cfg.num_experts
    C = capacity(cfg, T)
    route = moe_route(params, x, cfg)

    zero = x.new_zeros((1, d))
    xg = torch.cat([x, zero])[route.token_of_slot].reshape(E, C, d)  # token T: a zero row

    # the experts' SwiGLU, batched over E
    g = torch.bmm(xg, params["w_gate"])
    u = torch.bmm(xg, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, params["w_down"]).reshape(E * C, d)

    # combine: each (t, k) reads its slot; the overflow bin reads a zero row
    yk = torch.cat([y, zero])[route.slot]                          # (T, K, d)
    out = torch.sum(yk * route.gates[..., None], dim=1)
    if "shared" in params:
        out = out + swiglu(params["shared"], x)
    return out


def moe_aux_loss(logits_f32: torch.Tensor, topi: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss (fraction·probability dot), as the JAX
    package's: ``E · Σ_e frac_e · mean_t softmax(logits)_e``, where
    ``frac_e`` is the share of tokens whose first choice ``topi[:, 0]`` is
    ``e``.  No loss of either package calls it."""
    probs = torch.softmax(logits_f32, dim=-1)
    frac = torch.mean(F.one_hot(topi[..., 0].long(), E).to(torch.float32), dim=0)
    return E * torch.sum(frac * torch.mean(probs, dim=0))
