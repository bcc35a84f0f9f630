"""Logical-axis sharding rules (MaxText-style), the JAX package's tables
as plain data.

Models annotate tensors with *logical* axis names; a rule set maps logical
names to mesh axis names.  Rule sets per family:

* LM_RULES      — Megatron TP: heads/ff/vocab/experts → 'model';
                  batch → ('pod','data'); residual activations replicated
                  over 'model'.
* LM_RULES_SP   — + sequence parallelism: the residual stream's 'seq' axis
                  is sharded over 'model' between blocks.
* GNN_RULES     — edge/node arrays sharded over the flattened data×model
                  axes (edge partitioning); feature dims replicated.
* RECSYS_RULES  — embedding-table rows → 'model' (EP), batch → data axes.
* GRAPH_ENGINE_RULES — Sage engine: blocks → ('data','model'), vertex state
                  replicated.

The functions that apply them (``axis_rules``, ``logical_to_spec``,
``constrain``, ``spec_tree``) wait for the sharded cells.
"""
from __future__ import annotations

LM_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "res_seq": None,   # residual stream between blocks (SP shards this one)
    "act_embed": None,
    "cache_seq": None,
    # params: FSDP over 'data' on the embed dim + Megatron TP over 'model'
    "embed": "data",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "expert_cap": None,
    "layers": None,
    "kv_lora": None,
}

# sequence parallelism: residual stream sharded over 'model' between blocks
LM_RULES_SP = dict(LM_RULES, res_seq="model")

# serving: KV cache sharded along its sequence axis over 'model'
LM_PREFILL_RULES = dict(LM_RULES, cache_seq="model")
LM_DECODE_RULES = dict(LM_RULES, cache_seq="model")
# batch=1 long-context decode: cache over 'data', single query replicated
LM_DECODE_LONG_RULES = dict(LM_RULES, batch=None, cache_seq="data")

# A variant for long decode: a 500k MHA cache is ~215 GB global (qwen1.5-4b) — 16-way
# seq sharding leaves 13.4 GB/device.  Shard BOTH cache_seq (data) and
# head_dim/kv_lora (model) for 256-way placement (~0.9 GB/device); the
# attention einsum contracts the sharded head_dim with one small psum and
# the softmax reduces over the sharded seq axis.
LM_DECODE_LONG_RULES_V2 = dict(
    LM_RULES, batch=None, cache_seq="data", heads=None, head_dim="model",
    kv_lora="model",
)

GNN_RULES = {
    "nodes": ("pod", "data"),
    "edges": ("pod", "data", "model"),
    "feat": None,
    "batch": ("pod", "data"),
    "layers": None,
    "hidden": None,
}

# A variant: tensor-parallel channels instead of 512-way
# edge sharding — edge tensors shard (pod,data), hidden dim shards 'model',
# so the per-layer node-aggregation all-reduce carries 1/16 of the bytes and
# the (E, coef, d) message tensors never cross the model axis.
GNN_RULES_TP = dict(GNN_RULES, edges=("pod", "data"), hidden="model")

RECSYS_RULES = {
    "batch": ("pod", "data"),
    "vocab_rows": "model",
    "embed": None,
    "seq": None,
    "act_embed": None,
    "heads": None,
    "ff": None,
    "candidates": "model",
    "layers": None,
}

# retrieval_cand: one query, 10⁶ candidates sharded across the whole mesh
RECSYS_RETRIEVAL_RULES = dict(
    RECSYS_RULES, batch=None, candidates=("pod", "data", "model")
)

GRAPH_ENGINE_RULES = {
    "blocks": ("pod", "data", "model"),
    "slots": None,
    "vertices": None,
}
