"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The modules here import no toolchain at import time: a kernel is built on
its first CUDA call (``build.load_library``), and CPU tensors never reach
the build.
"""
from .compressed_spmv import (
    compressed_block_spmv,
    compressed_block_spmv_ref,
    compressed_chunked_spmv,
    compressed_chunked_spmv_ref,
    compressed_chunked_stream_tile,
    compressed_spmv_vertex,
    compressed_spmv_vertex_batched,
    compressed_spmv_vertex_chunked,
    compressed_spmv_vertex_ref,
    compressed_stream_round,
    compressed_stream_round_graph,
    compressed_stream_round_ref,
)
from .edge_block_spmv import (
    edge_block_spmv,
    edge_block_spmv_ref,
    real_slot_counts,
    spmv_vertex,
    spmv_vertex_batched,
    spmv_vertex_ref,
)
from .filter_pack import filter_pack, filter_pack_ref, filter_pack_words
from .embedding_bag import (
    BACKWARD_CHUNK,
    backward_plan,
    backward_sums_ref,
    bag_case,
    bag_grad_case,
    bag_of_one_case,
    bf16_ulps,
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_ref,
    embedding_bag_plan,
    embedding_bag_ref,
    embedding_bag_sums,
    same_bits,
    take_rows,
)
from .decode_attention import (
    ATTN_REL_TOL,
    decode_attention,
    decode_attention_ref,
    decode_attention_rel_err,
)
