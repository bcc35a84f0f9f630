"""EquiformerV2-style equivariant graph attention [arXiv:2306.12059].

Assigned config: 12 layers, d=128, l_max=6, m_max=2, 8 heads, eSCN SO(2)
convolutions.

Node features are spherical-tensor stacks (N, (l_max+1)², C).  Messages
combine the sender's coefficients with real spherical harmonics of the edge
direction and a radial MLP, with the eSCN m-truncation (only |m| ≤ m_max
coefficients are mixed across l; higher-m coefficients pass through gated
by scalar attention).  The Wigner rotation into the edge-aligned frame is
replaced by direct SH modulation, as in the JAX package: an SEGNN-flavored
approximation of eSCN with the same per-edge mixing cost, not an exactly
equivariant layer.  The (l, m) table, the m-truncation mask and the
coefficient indices are static, built on the host with numpy.

With ``part`` (an ``EdgeSlice``) the rank computes the geometry and
messages of its range of the edge list, gathering from whole node state,
and each layer combines the edge softmax and the (N, Cf, d) message sum
over the ranks; the node layers and the readout run on whole node state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve_device
from ...nn.mlp import init_from_specs, mlp2, mlp2_axes, mlp2_specs
from .aggregate import EdgeSlice, gather_src, maximum, scatter_sum, segment_softmax
from .heads import masked_ce, mse
from .sh import real_sph_harm, sh_index_table


# the batch leaf whose leading axis an edge split (``aggregate.EdgeSlice``) cuts
SPLIT = "edge_src"


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    """The JAX package's ``EquiformerV2Config``, field for field."""

    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_radial: int = 8
    d_in: int = 16
    n_classes: int = 1
    task: str = "graph"
    n_graphs: int = 0
    # gather only the |m| ≤ m_max coefficients to the edges (the eSCN
    # truncation applied to the communication): high-m coefficients evolve
    # node-locally
    compact_messages: bool = False

    @property
    def n_coef(self):
        return (self.l_max + 1) ** 2

    @property
    def channels(self):
        return self.d_hidden // self.n_heads  # per-head channels


def param_shapes(cfg: EquiformerV2Config) -> dict:
    """``{leaf: (shape, init)}`` of ``init`` (the JAX package's tree)."""
    d = cfg.d_hidden
    return {
        "encode": mlp2_specs(cfg.d_in, d, d),
        "layers": [{"w_src": ((d, d), d ** -0.5),
                    "w_dst": ((d, d), d ** -0.5),
                    "radial": mlp2_specs(cfg.n_radial, d, (cfg.l_max + 1) * d),
                    "attn": mlp2_specs(2 * d + cfg.n_radial, d, cfg.n_heads),
                    "w_m": ((2 * cfg.m_max + 1, d, d), d ** -0.5),
                    "ffn": mlp2_specs(d, 2 * d, d)} for _ in range(cfg.n_layers)],
        "head": mlp2_specs(d, d, cfg.n_classes),
    }


def init(cfg: EquiformerV2Config, *, generator: torch.Generator, device=None) -> dict:
    """Float32 parameters drawn from ``generator`` on ``device`` (default
    ``cuda``)."""
    return init_from_specs(param_shapes(cfg), generator=generator,
                           device=resolve_device(device))


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 by its formula,
    ``start * (1 - s) + stop * s`` for s = i / (num - 1), the last point
    ``stop``: bit for bit at Equiformer's ``n_radial`` of 8 (``torch.linspace``
    is one ulp off there); XLA's fused form may round a point of some other
    ``num`` one ulp away."""
    f32 = torch.float32
    s = torch.arange(num - 1, dtype=f32, device=device) / torch.tensor(num - 1, dtype=f32)
    lo, hi = torch.tensor(start, dtype=f32), torch.tensor(stop, dtype=f32)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1).to(device)])


def forward(params, batch, cfg: EquiformerV2Config, part: EdgeSlice | None = None):
    x, pos = batch["node_feat"], batch["pos"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    if part is not None:
        src, dst = part.take(src), part.take(dst)
    n = x.shape[0]
    Cf, d = cfg.n_coef, cfg.d_hidden
    dev = x.device

    # edge geometry
    sv = src.long().clamp_max(n - 1)
    dv = dst.long().clamp_max(n - 1)
    vec = pos.index_select(0, dv) - pos.index_select(0, sv)
    dist = torch.sqrt(maximum(torch.sum(vec * vec, dim=-1), 1e-12))
    u = vec / dist[:, None]
    Y = real_sph_harm(cfg.l_max, u)  # (E, Cf)
    rbf = torch.exp(-((dist[:, None] - linspace(0.0, 5.0, cfg.n_radial, dev)) ** 2))  # (E, R)
    valid = (src < n) & (dst < n)
    seg = dst.clamp_max(n)

    tab = sh_index_table(cfg.l_max)                 # host-side, static
    l_of = torch.as_tensor(tab[:, 0], device=dev)   # (Cf,)
    m_ok_np = np.abs(tab[:, 1]) <= cfg.m_max
    m_idx_np = np.clip(tab[:, 1], -cfg.m_max, cfg.m_max) + cfg.m_max
    sel_np = np.flatnonzero(m_ok_np)
    sel = torch.as_tensor(sel_np, device=dev)       # (Cs,)
    m_ok = torch.as_tensor(m_ok_np, device=dev)

    # node state: scalar channel h (N, d) + spherical stack f (N, Cf, d)
    h = mlp2(params["encode"], x)
    f = torch.cat([h[:, None, :], h.new_zeros((n, Cf - 1, d))], dim=1)

    for lp in params["layers"]:
        hs, hd = gather_src(h, src), gather_src(h, dst)
        # per-edge scalar attention (n_heads heads)
        logits = mlp2(lp["attn"], torch.cat([hs, hd, rbf], dim=-1))
        logits = torch.where(valid[:, None], logits, -1e30)
        alpha = segment_softmax(logits, seg, n, part)                    # (E, H)
        gate = torch.repeat_interleave(alpha, d // cfg.n_heads, dim=-1)  # (E, d)

        # radial per-l gains
        rl = mlp2(lp["radial"], rbf).reshape(-1, cfg.l_max + 1, d)  # (E, L+1, d)
        gain = rl.index_select(1, l_of)                             # (E, Cf, d)
        inject = (hs @ lp["w_src"])[:, None, :]

        if cfg.compact_messages:
            # gather/scatter only the m-truncated coefficient subset
            fs = f.index_select(1, sel).index_select(0, sv)         # (E, Cs, d)
            wm = lp["w_m"][torch.as_tensor(m_idx_np[sel_np], device=dev)]  # (Cs, d, d)
            fs = torch.einsum("ecd,cdk->eck", fs, wm)
            msg = fs * gain.index_select(1, sel) + Y.index_select(1, sel)[:, :, None] * inject
            msg = msg * gate[:, None, :]
            msg = torch.where(valid[:, None, None], msg, 0.0)
            f = f.index_add(1, sel, scatter_sum(msg, seg, n, part))  # (N, Cs, d) added
        else:
            fs = f.index_select(0, sv)                               # (E, Cf, d)
            # eSCN m-truncated channel mixing: coefficients with |m| ≤ m_max
            # get a per-m linear map; higher-m coefficients pass through.
            wm = lp["w_m"][torch.as_tensor(m_idx_np, device=dev)]    # (Cf, d, d)
            mixed = torch.einsum("ecd,cdk->eck", fs, wm)
            fs = torch.where(m_ok[None, :, None], mixed, fs)
            # SH injection from the scalar channel (creates higher-l content)
            msg = fs * gain + Y[:, :, None] * inject
            msg = msg * gate[:, None, :]
            msg = torch.where(valid[:, None, None], msg, 0.0)
            f = f + scatter_sum(msg, seg, n, part)                   # (N, Cf, d)
        # equivariant norm-gated nonlinearity on l>0, MLP on l=0
        norms = torch.sqrt(maximum(torch.sum(f[:, 1:, :] ** 2, dim=1), 1e-12))
        h = h + mlp2(lp["ffn"], f[:, 0, :] + (norms @ lp["w_dst"]) / Cf)
        f = torch.cat([h[:, None, :], f[:, 1:, :]], dim=1)

    if cfg.task == "graph":
        return mlp2(params["head"], scatter_sum(h, batch["node_graph"], cfg.n_graphs))
    return mlp2(params["head"], h)


def loss_fn(params, batch, cfg: EquiformerV2Config, part: EdgeSlice | None = None):
    out = forward(params, batch, cfg, part)
    if cfg.n_classes == 1:
        return mse(out[..., 0], batch["graph_labels" if cfg.task == "graph" else "labels"])
    return masked_ce(out.float(), batch["labels"])


def param_specs(cfg: EquiformerV2Config):
    """Logical axis names of every leaf (the JAX package's)."""
    return {
        "encode": mlp2_axes(),
        "layers": [
            {
                "w_src": (None, "hidden"),
                "w_dst": (None, "hidden"),
                "radial": mlp2_axes(),
                "attn": mlp2_axes(),
                "w_m": (None, None, "hidden"),
                "ffn": mlp2_axes(),
            }
            for _ in range(cfg.n_layers)
        ],
        "head": mlp2_axes(),
    }
