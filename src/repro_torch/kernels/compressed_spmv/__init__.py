from .compressed_spmv import (
    ROUND_MAPS,
    compressed_block_spmv,
    compressed_chunked_spmv,
    compressed_stream_round,
)
from .ops import (
    compressed_chunked_stream_tile,
    compressed_stream_round_graph,
    compressed_spmv_vertex,
    compressed_spmv_vertex_batched,
    compressed_spmv_vertex_chunked,
)
from .ref import (
    compressed_block_spmv_ref,
    compressed_chunked_spmv_ref,
    compressed_spmv_vertex_ref,
    compressed_stream_round_ref,
)
