"""repro_torch.distributed — the logical-axis rules and their placement on
a process mesh (``shardings``), elastic re-carving and restore
(``elastic``), the serving state sharded over a process mesh (``serving``:
a cache's row ranges and the merge of their attention partials, a
row-sharded table's lookups and top-k), the GNN aggregation with its edge
lists split over a process mesh (``gnn``: ``edge_slice`` and its combines),
the LM's training compute on its blocks (``fsdp``: a layer's leaves gathered
over the batch axes one layer at a time, their gradients reduce-scattered;
``tensor_parallel``: Megatron's ``copy_to`` / ``reduce_from`` and the
vocabulary-parallel lookup and cross-entropy over ``model``), and the
edge-partitioned graph
engine's helpers, thin specializations of the sharded planner
(``repro_torch.core.plan``), on an in-process ``ShardMesh`` or a
``ProcessMesh`` (one shard a rank, ``repro_torch.core.make_process_mesh``)."""
from .elastic import carve_mesh, carve_shape, elastic_restore
from .engine import (
    distributed_frontier_min,
    distributed_pagerank_step,
    distributed_vertex_reduce,
    prepare_sharded,
    shard_blocks_for_mesh,
)
from .fsdp import gather_rows, gathered, held
from .gnn import edge_slice
from .serving import (
    local_rows,
    merge_attention,
    merge_topk,
    seq_block,
    sharded_rows,
)
from .shardings import (
    GNN_RULES,
    GNN_RULES_TP,
    GRAPH_ENGINE_RULES,
    LM_DECODE_LONG_RULES,
    LM_DECODE_LONG_RULES_V2,
    LM_DECODE_RULES,
    LM_PREFILL_RULES,
    LM_RULES,
    LM_RULES_SP,
    RECSYS_RETRIEVAL_RULES,
    RECSYS_RULES,
    PartitionSpec,
    axis_rules,
    constrain,
    gather_blocks,
    gather_tree,
    logical_to_spec,
    reduce_scatter_blocks,
    shard_block,
    shard_tree,
    spec_tree,
)
from .tensor_parallel import copy_to, reduce_from, vocab_cross_entropy, vocab_lookup

__all__ = [
    "axis_rules",
    "constrain",
    "logical_to_spec",
    "spec_tree",
    "PartitionSpec",
    "shard_block",
    "gather_blocks",
    "reduce_scatter_blocks",
    "shard_tree",
    "gather_tree",
    "carve_mesh",
    "carve_shape",
    "elastic_restore",
    "seq_block",
    "edge_slice",
    "gathered",
    "held",
    "gather_rows",
    "copy_to",
    "reduce_from",
    "vocab_lookup",
    "vocab_cross_entropy",
    "merge_attention",
    "local_rows",
    "sharded_rows",
    "merge_topk",
    "LM_RULES",
    "LM_RULES_SP",
    "LM_PREFILL_RULES",
    "LM_DECODE_RULES",
    "LM_DECODE_LONG_RULES",
    "LM_DECODE_LONG_RULES_V2",
    "RECSYS_RETRIEVAL_RULES",
    "GNN_RULES",
    "GNN_RULES_TP",
    "RECSYS_RULES",
    "GRAPH_ENGINE_RULES",
    "distributed_frontier_min",
    "distributed_pagerank_step",
    "distributed_vertex_reduce",
    "prepare_sharded",
    "shard_blocks_for_mesh",
]
