"""repro_torch.distributed — the edge-partitioned graph engine's helpers,
thin specializations of the sharded planner (``repro_torch.core.plan``)."""
from .engine import (
    distributed_frontier_min,
    distributed_pagerank_step,
    distributed_vertex_reduce,
    prepare_sharded,
    shard_blocks_for_mesh,
)

__all__ = [
    "distributed_frontier_min",
    "distributed_pagerank_step",
    "distributed_vertex_reduce",
    "prepare_sharded",
    "shard_blocks_for_mesh",
]
