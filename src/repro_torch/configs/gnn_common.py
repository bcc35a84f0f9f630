"""Shared GNN cell factory: every GNN arch × the 4 assigned graph shapes.

Shapes are padded so sharded dims divide both production meshes (nodes →
×32, edges → ×512); sentinel indices point at the padded tail.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.neighbor_sampler import padded_sizes
from ..device import resolve_device
from ..distributed.shardings import GNN_RULES
from .common import GNN_SHAPES, TRIPLET_CAP, Cell, f32, i32


def _pad(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# per-shape task info: (task, n_classes, n_graphs)
SHAPE_TASK = {
    "full_graph_sm": ("node", 7, None),        # cora
    "minibatch_lg": ("node", 41, None),        # reddit
    "ogb_products": ("node", 47, None),
    "molecule": ("graph", 1, 128),
}


def gnn_shape_dims(shape: str) -> tuple[int, int, int]:
    """(padded nodes, padded edges, d_feat)."""
    info = GNN_SHAPES[shape]
    if shape == "minibatch_lg":
        n, e = padded_sizes(info["batch_nodes"], info["fanout"])
    elif shape == "molecule":
        n = info["n_nodes"] * info["batch"]
        e = info["n_edges"] * info["batch"] * 2
    else:
        n, e = info["n_nodes"], info["n_edges"]
    return _pad(n, 32), _pad(e, 512), info["d_feat"]


def gnn_cells(
    arch: str,
    module,
    base_cfg,
    *,
    with_pos: bool,
    with_triplets: bool,
    flops_fn=None,
) -> dict[str, Cell]:
    cells = {}
    for shape in GNN_SHAPES:
        n, e, d_feat = gnn_shape_dims(shape)
        task, n_classes, n_graphs = SHAPE_TASK[shape]
        kwargs = dict(d_in=d_feat, task=task)
        if hasattr(base_cfg, "n_classes"):
            kwargs["n_classes"] = n_classes if task == "node" else 1
        if n_graphs is not None:
            kwargs["n_graphs"] = n_graphs
        cfg = dataclasses.replace(base_cfg, **kwargs)

        specs = {
            "node_feat": f32(n, d_feat),
            "edge_src": i32(e),
            "edge_dst": i32(e),
        }
        logical = {
            "node_feat": ("nodes", None),
            "edge_src": ("edges",),
            "edge_dst": ("edges",),
        }
        if with_pos:
            specs["pos"] = f32(n, 3)
            logical["pos"] = ("nodes", None)
        if with_triplets:
            t = e * TRIPLET_CAP[shape]
            specs["t_kj"] = i32(t)
            specs["t_ji"] = i32(t)
            logical["t_kj"] = ("edges",)
            logical["t_ji"] = ("edges",)
        if task == "graph":
            specs["node_graph"] = i32(n)
            specs["graph_labels"] = f32(n_graphs)
            logical["node_graph"] = ("nodes",)
            logical["graph_labels"] = (None,)
        else:
            specs["labels"] = i32(n)
            logical["labels"] = ("nodes",)

        cells[shape] = Cell(
            arch=arch,
            shape=shape,
            kind="train",
            family="gnn",
            model_cfg=cfg,
            batch_specs=specs,
            batch_logical=logical,
            rules=GNN_RULES,
            model_flops=flops_fn(cfg, n, e) if flops_fn else 0.0,
        )
    return cells


def gnn_smoke_batch(key_seed: int, *, d_in=16, with_pos=False, with_triplets=False,
                    task="node", n_classes=8, n_graphs=4, device=None):
    """Tiny real-array batch for CPU smoke tests: the JAX package's numpy
    draws from ``key_seed``, as tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(key_seed)
    N, E = 24, 64
    draws = {
        "node_feat": rng.normal(size=(N, d_in)).astype(np.float32),
        "edge_src": rng.integers(0, N, E).astype(np.int32),
        "edge_dst": rng.integers(0, N, E).astype(np.int32),
    }
    if with_pos:
        draws["pos"] = rng.normal(size=(N, 3)).astype(np.float32)
    if with_triplets:
        T = 96
        draws["t_kj"] = rng.integers(0, E, T).astype(np.int32)
        draws["t_ji"] = rng.integers(0, E, T).astype(np.int32)
    if task == "graph":
        draws["node_graph"] = rng.integers(0, n_graphs, N).astype(np.int32)
        draws["graph_labels"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    else:
        draws["labels"] = rng.integers(0, n_classes, N).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in draws.items()}
