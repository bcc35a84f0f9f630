from .edge_block_spmv import edge_block_spmv
from .ops import spmv_vertex, spmv_vertex_batched
from .ref import edge_block_spmv_ref, real_slot_counts, spmv_vertex_ref
