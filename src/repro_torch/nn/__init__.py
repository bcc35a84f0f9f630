"""Neural-network building blocks of the LM serving path (norms, rotary,
SwiGLU, attention, the mixture-of-experts FFN and its load-balance loss)
and the GNNs' two-layer MLP, as plain functions on dicts of tensors (the
JAX package's ``nn/`` layouts, leaf by leaf)."""
from .attention import NEG_INF, gqa_attention, partial_attention
from .mlp import gelu, init_mlp2, init_swiglu, mlp2, swiglu
from .moe import MoECfg, capacity, init_moe, moe_aux_loss, moe_ffn, moe_route
from .norms import layer_norm, rms_norm
from .rotary import apply_rope, rope_freqs
