"""repro_torch.optim — AdamW, clipping, schedules and int8 compression as
pure functions over the port's parameter trees (the JAX package's
``repro.optim``); ``compressed_psum`` runs over an axis of a
``ProcessMesh``."""
from .adamw import AdamWConfig
from .adamw import init as adamw_init
from .adamw import state_logical_specs
from .adamw import update as adamw_update
from .clipping import clip_by_global_norm, global_norm
from .compression import (
    compress_tree,
    compressed_psum,
    decompress_tree,
    dequantize_int8,
    quantize_int8,
)
from .schedules import warmup_cosine
from .tree import tree_leaves, tree_map

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "state_logical_specs",
    "clip_by_global_norm", "global_norm",
    "compressed_psum", "quantize_int8", "dequantize_int8", "compress_tree", "decompress_tree",
    "warmup_cosine", "tree_map", "tree_leaves",
]
