"""DimeNet — Directional Message Passing [arXiv:2003.03123].

Config: 6 interaction blocks, d=128, n_bilinear=8, n_spherical=7, n_radial=6.
Messages live on *directed edges*; interaction blocks mix incoming messages
m_kj into m_ji weighted by a spherical-radial basis of the angle ∠(kj, ji)
via a bilinear layer.  Triplet lists (t_kj, t_ji index pairs into the edge
list, padded with E) come with the batch.

Where the JAX package's gradient is not finite the port's is: a triplet
whose cosine reaches ±1 (the edges collinear, or ``t_kj == t_ji``) has an
angle of zero gradient here (JAX: -inf at ±1, NaN past it, through
``arccos(clip(c))``), and a self-loop's zero vector a norm of zero gradient
(JAX: NaN).  Every value is JAX's.

With ``part`` (an ``EdgeSlice`` of the triplet list, whose T = E x the
cell's triplet cap dominates the blocks) the rank computes the geometry
and messages of its triplets and combines their sum into the E edges; the
(E, d) edge state plays the part of vertex state, whole on every rank, as
do the node layers and the readout.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...nn.mlp import init_from_specs, mlp2, mlp2_axes, mlp2_specs
from .aggregate import EdgeSlice, gather_src, maximum, scatter_sum
from .heads import mse


# the batch leaf whose leading axis an edge split (``aggregate.EdgeSlice``) cuts
SPLIT = "t_kj"


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    """The JAX package's ``DimeNetConfig``, field for field."""

    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_in: int = 16
    task: str = "graph"  # per-graph energy regression
    n_graphs: int = 0


def _rbf(dist, n_radial, cutoff):
    """Bessel-style radial basis (sin(nπ d/c)/d), DimeNet eq. 7."""
    d = maximum(dist, 1e-6)[..., None]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=dist.device)
    env = torch.where(dist[..., None] < cutoff, 1.0, 0.0)
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d * env


def _sbf(angle, dist, n_spherical, n_radial, cutoff):
    """Spherical basis: cos(l·θ) ⊗ radial sin basis (simplified Y_l0⊗j_l)."""
    l = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    ang = torch.cos(l * angle[..., None])  # (T, S)
    rad = _rbf(dist, n_radial, cutoff)    # (T, R)
    return (ang[..., :, None] * rad[..., None, :]).reshape(
        angle.shape + (n_spherical * n_radial,))


def _angle(c: torch.Tensor) -> torch.Tensor:
    """``arccos(clip(c, -1, 1))``, its gradient 0 where |c| >= 1."""
    inside = c.abs() < 1.0
    return torch.where(inside, torch.arccos(torch.where(inside, c, 0.0)),
                       torch.arccos(c.clamp(-1.0, 1.0)).detach())


def param_shapes(cfg: DimeNetConfig) -> dict:
    """``{leaf: (shape, init)}`` of ``init`` (the JAX package's tree)."""
    d, nb = cfg.d_hidden, cfg.n_bilinear
    sbf_dim = cfg.n_spherical * cfg.n_radial
    return {
        "embed_node": mlp2_specs(cfg.d_in, d, d),
        "embed_edge": mlp2_specs(2 * d + cfg.n_radial, d, d),
        "blocks": [{"w_self": ((d, d), d ** -0.5),
                    "w_kj": ((d, nb), d ** -0.5),
                    "w_sbf": ((sbf_dim, nb), sbf_dim ** -0.5),
                    "w_bil": ((nb, d), nb ** -0.5),
                    "update": mlp2_specs(d, d, d)} for _ in range(cfg.n_blocks)],
        "out_edge": ((d, d), d ** -0.5),
        "head": mlp2_specs(d, d, 1),
    }


def init(cfg: DimeNetConfig, *, generator: torch.Generator, device=None) -> dict:
    """Float32 parameters drawn from ``generator`` on ``device`` (default
    ``cuda``)."""
    return init_from_specs(param_shapes(cfg), generator=generator,
                           device=resolve_device(device))


def forward(params, batch, cfg: DimeNetConfig, part: EdgeSlice | None = None):
    x, pos = batch["node_feat"], batch["pos"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    t_kj, t_ji = batch["t_kj"].long(), batch["t_ji"].long()  # indices into edges, pad=E
    if part is not None:
        t_kj, t_ji = part.take(t_kj), part.take(t_ji)
    n = x.shape[0]
    E = src.shape[0]

    h = mlp2(params["embed_node"], x)
    vec = (pos.index_select(0, dst.long().clamp_max(n - 1))
           - pos.index_select(0, src.long().clamp_max(n - 1)))
    dist = torch.sqrt(maximum(torch.sum(vec * vec, dim=-1), 1e-12))
    rbf = _rbf(dist, cfg.n_radial, cfg.cutoff)  # (E, R)
    m = mlp2(params["embed_edge"],
             torch.cat([gather_src(h, src), gather_src(h, dst), rbf], dim=-1))  # (E, d)

    # triplet geometry: angle between edge kj and ji
    kj, ji = t_kj.clamp_max(E - 1), t_ji.clamp_max(E - 1)
    vkj, vji = vec.index_select(0, kj), vec.index_select(0, ji)
    cosang = torch.sum(vkj * vji, dim=-1) / maximum(
        torch.linalg.vector_norm(vkj, dim=-1) * torch.linalg.vector_norm(vji, dim=-1), 1e-12)
    sbf = _sbf(_angle(cosang), dist.index_select(0, ji), cfg.n_spherical, cfg.n_radial,
               cfg.cutoff)  # (T, S*R)
    tvalid = ((t_kj < E) & (t_ji < E))[:, None]
    seg = torch.where(tvalid[:, 0], t_ji, E)

    for bp in params["blocks"]:
        a = m.index_select(0, kj) @ bp["w_kj"]                # (T, nb)
        b = sbf @ bp["w_sbf"]                                 # (T, nb)
        tmsg = torch.where(tvalid, a * b, 0.0) @ bp["w_bil"]  # (T, d)
        agg = scatter_sum(tmsg, seg, E, part)
        m = m + mlp2(bp["update"], F.silu(m @ bp["w_self"] + agg))

    # per-node output: sum incident directed-edge messages
    node_out = scatter_sum(m @ params["out_edge"], dst.clamp_max(n), n)
    per_node = mlp2(params["head"], F.silu(node_out))[:, 0]
    if cfg.task == "graph":
        return scatter_sum(per_node, batch["node_graph"], cfg.n_graphs)
    return per_node


def loss_fn(params, batch, cfg: DimeNetConfig, part: EdgeSlice | None = None):
    return mse(forward(params, batch, cfg, part),
               batch["graph_labels" if cfg.task == "graph" else "labels"])


def param_specs(cfg: DimeNetConfig):
    """Logical axis names of every leaf (the JAX package's)."""
    return {
        "embed_node": mlp2_axes(),
        "embed_edge": mlp2_axes(),
        "blocks": [
            {
                "w_self": (None, "hidden"),
                "w_kj": (None, "hidden"),
                "w_sbf": (None, "hidden"),
                "w_bil": ("hidden", None),
                "update": mlp2_axes(),
            }
            for _ in range(cfg.n_blocks)
        ],
        "out_edge": (None, "hidden"),
        "head": mlp2_axes(),
    }
