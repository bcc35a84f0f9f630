"""GIN — Graph Isomorphism Network [arXiv:1810.00826], TU-benchmark config:
5 layers, d=64, sum aggregator, learnable ε (a 0-d leaf).

With ``part`` (an ``EdgeSlice``) the rank aggregates its range of the edge
list and combines the sums; the node layers and the readout run on whole
node state."""
from __future__ import annotations

import dataclasses

import torch

from ...device import resolve_device
from ...nn.mlp import init_from_specs, mlp2, mlp2_axes, mlp2_specs
from .aggregate import EdgeSlice, gather_src, scatter_sum
from .heads import masked_ce, mse


# the batch leaf whose leading axis an edge split (``aggregate.EdgeSlice``) cuts
SPLIT = "edge_src"


@dataclasses.dataclass(frozen=True)
class GINConfig:
    """The JAX package's ``GINConfig``, field for field."""

    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 16
    n_classes: int = 8
    task: str = "graph"
    n_graphs: int = 0


def param_shapes(cfg: GINConfig) -> dict:
    """``{leaf: (shape, init)}`` of ``init`` (the JAX package's tree)."""
    d = cfg.d_hidden
    return {
        "encode": mlp2_specs(cfg.d_in, d, d),
        "layers": [{"mlp": mlp2_specs(d, 2 * d, d), "eps": ((), "zeros")}
                   for _ in range(cfg.n_layers)],
        "head": mlp2_specs(d * (cfg.n_layers + 1), d, cfg.n_classes),
    }


def init(cfg: GINConfig, *, generator: torch.Generator, device=None) -> dict:
    """Float32 parameters drawn from ``generator`` on ``device`` (default
    ``cuda``)."""
    return init_from_specs(param_shapes(cfg), generator=generator,
                           device=resolve_device(device))


def forward(params, batch, cfg: GINConfig, part: EdgeSlice | None = None):
    x = batch["node_feat"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    if part is not None:
        src, dst = part.take(src), part.take(dst)
    n = x.shape[0]
    h = mlp2(params["encode"], x)
    reps = [h]
    for lp in params["layers"]:
        agg = scatter_sum(gather_src(h, src), dst, n, part)
        h = torch.relu(mlp2(lp["mlp"], (1.0 + lp["eps"]) * h + agg))
        reps.append(h)
    hcat = torch.cat(reps, dim=-1)
    if cfg.task == "graph":
        return mlp2(params["head"], scatter_sum(hcat, batch["node_graph"], cfg.n_graphs))
    return mlp2(params["head"], hcat)


def loss_fn(params, batch, cfg: GINConfig, part: EdgeSlice | None = None):
    """Squared error for one output (the molecule cells' regression head),
    else the masked cross-entropy; against ``graph_labels`` for a graph
    task, ``labels`` for a node task."""
    logits = forward(params, batch, cfg, part).float()
    labels = batch["graph_labels" if cfg.task == "graph" else "labels"]
    if cfg.n_classes == 1:
        return mse(logits[..., 0], labels)
    return masked_ce(logits, labels)


def param_specs(cfg: GINConfig):
    """Logical axis names of every leaf (the JAX package's)."""
    return {
        "encode": mlp2_axes(),
        "layers": [{"mlp": mlp2_axes(), "eps": ()} for _ in range(cfg.n_layers)],
        "head": mlp2_axes(),
    }
