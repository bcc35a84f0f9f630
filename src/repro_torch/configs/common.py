"""Shared cell machinery for the assigned architecture × shape grid.

A **Cell** is one (architecture, input-shape) pair: its model config, the
``TensorSpec`` stand-ins for every step input, the logical sharding of
those inputs, the step kind, and the sharding rule set — the JAX package's
``Cell``, with ``TensorSpec(shape, dtype)`` (a torch dtype) in place of
``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..data.neighbor_sampler import padded_sizes


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one step input (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode | serve | retrieval
    family: str                    # lm | gnn | recsys
    model_cfg: Any
    batch_specs: dict              # name → TensorSpec (or tree thereof)
    batch_logical: dict            # name → logical-axis tuple (or tree)
    rules: dict                    # logical → mesh axes for this cell
    notes: str = ""
    # model-FLOPs estimate (per step, fwd+bwd for train, fwd for serve)
    model_flops: float = 0.0


def i32(*shape):
    return TensorSpec(tuple(shape), torch.int32)


def f32(*shape):
    return TensorSpec(tuple(shape), torch.float32)


def bf16(*shape):
    return TensorSpec(tuple(shape), torch.bfloat16)


# ----------------------------------------------------------------------
# LM cell shapes and model flops
# ----------------------------------------------------------------------
LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def lm_model_flops(cfg, seq: int, batch: int, *, train: bool, decode: bool = False):
    """6·N·D (dense) / 6·N_active·D (MoE) + attention term."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    if cfg.attn == "mla":
        dqk = cfg.nope_head_dim + cfg.rope_head_dim
        attn_p = d * (
            cfg.n_heads * dqk + cfg.kv_lora_rank + cfg.rope_head_dim
        ) + cfg.kv_lora_rank * cfg.n_heads * (
            cfg.nope_head_dim + cfg.v_head_dim
        ) + cfg.n_heads * cfg.v_head_dim * d
    else:
        attn_p = d * cfg.d_head * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    if cfg.moe:
        ffn_active = 3 * d * cfg.d_ff_expert * (cfg.top_k + cfg.n_shared)
        dense_layers = cfg.first_dense_layers
        ffn_p = ffn_active * (L - dense_layers) / L + (
            3 * d * cfg.d_ff * dense_layers / L
        )
    else:
        ffn_p = 3 * d * cfg.d_ff
    n_active = L * (attn_p + ffn_p) + V * d  # + embeddings
    tokens = batch * (1 if decode else seq)
    mult = 6 if train else 2
    flops = mult * n_active * tokens
    # attention score/AV FLOPs (per token ~ 2·2·d_attn·context)
    ctx = seq if (decode or not train) else seq / 2
    dh = cfg.n_heads * (
        cfg.nope_head_dim + cfg.rope_head_dim if cfg.attn == "mla" else cfg.d_head
    )
    flops += mult / 3 * 2 * 2 * tokens * ctx * dh * L
    return float(flops)


# ----------------------------------------------------------------------
# GNN shape table
# ----------------------------------------------------------------------
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(
        n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024, fanout=(15, 10),
        d_feat=602,
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
}

# triplets-per-edge cap for directional models (exact for molecules, sampled
# for big graphs)
TRIPLET_CAP = {
    "full_graph_sm": 8,
    "minibatch_lg": 4,
    "ogb_products": 1,
    "molecule": 16,
}


def gnn_graph_specs(shape_name: str, *, with_pos: bool, with_triplets: bool,
                    n_graphs: int | None = None):
    """``TensorSpec``s for a GNN batch of the given assigned shape."""
    info = GNN_SHAPES[shape_name]
    if shape_name == "minibatch_lg":
        n, e = padded_sizes(info["batch_nodes"], info["fanout"])
    elif shape_name == "molecule":
        n = info["n_nodes"] * info["batch"]
        e = info["n_edges"] * info["batch"] * 2  # symmetrized
    else:
        n, e = info["n_nodes"], info["n_edges"]
    specs = {
        "node_feat": f32(n, info["d_feat"]),
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
        t = e * TRIPLET_CAP[shape_name]
        specs["t_kj"] = i32(t)
        specs["t_ji"] = i32(t)
        logical["t_kj"] = ("edges",)
        logical["t_ji"] = ("edges",)
    if n_graphs is not None:
        specs["node_graph"] = i32(n)
        specs["graph_labels"] = i32(n_graphs)
        logical["node_graph"] = ("nodes",)
        logical["graph_labels"] = (None,)
    else:
        specs["labels"] = i32(n)
        logical["labels"] = ("nodes",)
    return specs, logical, n, e
