"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The modules here import no toolchain at import time: a kernel is built on
its first CUDA call (``build.load_library``), and CPU tensors never reach
the build.
"""
from .compressed_spmv import (
    compressed_chunked_spmv,
    compressed_chunked_spmv_ref,
    compressed_chunked_stream_tile,
    compressed_spmv_vertex_chunked,
)
