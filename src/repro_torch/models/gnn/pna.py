"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

4 aggregators (mean/max/min/std) × 3 degree scalers (identity /
amplification / attenuation) → 12·d message concat → linear → update MLP,
with residual.  n_layers=4, d_hidden=75 per the assigned config.

With ``part`` (an ``EdgeSlice``) the rank aggregates its range of the edge
list: the degrees, hence δ and the scalers, and the four aggregators are
combined over the ranks; the node layers run on whole node state.
"""
from __future__ import annotations

import dataclasses

import torch

from ...device import resolve_device
from ...nn.mlp import init_from_specs, mlp2, mlp2_axes, mlp2_specs
from .aggregate import (
    EdgeSlice,
    degrees,
    gather_src,
    maximum,
    scatter_max,
    scatter_mean,
    scatter_min,
    scatter_std,
    scatter_sum,
)
from .heads import masked_ce, mse


# the batch leaf whose leading axis an edge split (``aggregate.EdgeSlice``) cuts
SPLIT = "edge_src"


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    """The JAX package's ``PNAConfig``, field for field."""

    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    n_classes: int = 16
    task: str = "node"  # node classification | "graph" regression
    n_graphs: int = 0


def param_shapes(cfg: PNAConfig) -> dict:
    """``{leaf: (shape, init)}`` of ``init`` (the JAX package's tree)."""
    d = cfg.d_hidden
    return {
        "encode": mlp2_specs(cfg.d_in, d, d),
        "layers": [{"msg": mlp2_specs(2 * d, d, d),
                    "post": ((12 * d, d), (12 * d) ** -0.5),
                    "update": mlp2_specs(2 * d, d, d)} for _ in range(cfg.n_layers)],
        "head": mlp2_specs(d, d, cfg.n_classes),
    }


def init(cfg: PNAConfig, *, generator: torch.Generator, device=None) -> dict:
    """Float32 parameters drawn from ``generator`` on ``device`` (default
    ``cuda``)."""
    return init_from_specs(param_shapes(cfg), generator=generator,
                           device=resolve_device(device))


def forward(params, batch, cfg: PNAConfig, part: EdgeSlice | None = None):
    x = batch["node_feat"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    if part is not None:
        src, dst = part.take(src), part.take(dst)
    n = x.shape[0]
    h = mlp2(params["encode"], x)
    deg = degrees(torch.clamp_max(dst, n), n, part)
    logd = torch.log1p(deg)
    delta = torch.mean(torch.where(deg > 0, logd, 0.0)) + 1e-6  # batch-estimated δ
    amp = (logd / delta)[:, None]
    att = (delta / maximum(logd, 1e-6))[:, None]
    present = (deg > 0)[:, None]

    for lp in params["layers"]:
        hs = gather_src(h, src)
        hd = gather_src(h, dst)
        m = mlp2(lp["msg"], torch.cat([hs, hd], dim=-1))
        aggs = [
            scatter_mean(m, dst, n, deg=deg, part=part),
            scatter_max(m, dst, n, part=part),
            scatter_min(m, dst, n, part=part),
            scatter_std(m, dst, n, deg=deg, part=part),
        ]
        aggs = [torch.where(present, a, 0.0) for a in aggs]  # isolated nodes → 0
        scaled = []
        for a in aggs:
            scaled += [a, a * amp, a * att]
        agg = torch.cat(scaled, dim=-1) @ lp["post"]
        h = h + mlp2(lp["update"], torch.cat([h, agg], dim=-1))
    if cfg.task == "graph":
        return mlp2(params["head"], scatter_sum(h, batch["node_graph"], cfg.n_graphs))
    return mlp2(params["head"], h)


def loss_fn(params, batch, cfg: PNAConfig, part: EdgeSlice | None = None):
    out = forward(params, batch, cfg, part)
    if cfg.task == "graph":
        return mse(out[..., 0], batch["graph_labels"])
    return masked_ce(out.float(), batch["labels"])


def param_specs(cfg: PNAConfig):
    """Logical axis names of every leaf (the JAX package's)."""
    return {
        "encode": mlp2_axes(),
        "layers": [
            {"msg": mlp2_axes(), "post": (None, "hidden"), "update": mlp2_axes()}
            for _ in range(cfg.n_layers)
        ],
        "head": mlp2_axes(),
    }
