"""The Sage engine in PyTorch: graph formats, filters, edgeMap, the planner
(single-device, sharded over a ``ShardMesh`` in one process, or one shard
a process over a ``ProcessMesh``) and the PSAM cost model."""
from .backend import GraphBackend, GraphLike, dense_block_view, tile_block_view
from .bucketing import NULL_BUCKET, Buckets, make_buckets
from .compressed import (
    ESCAPE,
    CompressedCSR,
    compress,
    decode_block,
    decode_block_tile,
    decode_blocks,
    edgemap_sum_compressed,
    exception_dense,
)
from .convert import (
    delta_from_reference_arrays,
    filter_from_reference_arrays,
    filter_to_reference_arrays,
    from_reference_arrays,
    to_reference_arrays,
)
from .csr import DEFAULT_BLOCK_SIZE, CSRGraph, build_csr, graph_spec, sharded_block_counts
from .edgemap import (
    edge_map,
    edge_map_batched,
    edgemap_chunked,
    edgemap_chunked_batched_streamed,
    edgemap_dense,
    edgemap_dense_batched,
    edgemap_reduce,
    edgemap_reduce_batched,
)
from .graph_filter import (
    GraphFilter,
    edge_active_flat,
    edge_active_words,
    filter_edges,
    filter_edges_pred,
    live_block_indices,
    make_filter,
    pack_bits,
    pack_vertices,
    unpack_bits,
    unpack_word_bits,
)
from .mesh import ProcessMesh, ShardMesh, make_mesh, make_process_mesh
from .plan import (
    ExecutionPlan,
    ShardedEdgeActive,
    ShardedGraph,
    compact_live_blocks,
    make_plan,
    round_loop,
    shard_edge_active,
    sharded_edgemap_reduce,
    sharded_edgemap_reduce_batched,
    sharded_graph_spec,
)
from .primitives import (
    compact_mask,
    exclusive_scan,
    histogram,
    lowest_set_bit,
    mex_from_forbidden,
    monoid_identity,
    popcount32,
    segment_reduce,
)
from .psam import PSAMCost, TenantLedger, TenantLedgers, edgemap_round_read_words
from .vertex_subset import VertexSubset, empty, from_indices, from_mask, full
