"""repro_torch.optim — AdamW, clipping, schedules and int8 compression as
pure functions over the port's parameter trees (the JAX package's
``repro.optim``, less ``state_logical_specs`` and ``compressed_psum``,
which wait for the sharded cells and the ``torch.distributed`` combine)."""
from .adamw import AdamWConfig
from .adamw import init as adamw_init
from .adamw import update as adamw_update
from .clipping import clip_by_global_norm, global_norm
from .compression import compress_tree, decompress_tree, dequantize_int8, quantize_int8
from .schedules import warmup_cosine
from .tree import tree_leaves, tree_map

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm",
    "quantize_int8", "dequantize_int8", "compress_tree", "decompress_tree",
    "warmup_cosine", "tree_map", "tree_leaves",
]
