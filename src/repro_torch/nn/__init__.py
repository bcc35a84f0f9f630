"""Neural-network building blocks of the LM serving path (norms, rotary,
SwiGLU, attention, the mixture-of-experts FFN and its load-balance loss), as plain functions on
dicts of tensors (the JAX package's ``nn/`` layouts, leaf by leaf)."""
from .attention import NEG_INF, gqa_attention
from .mlp import init_swiglu, swiglu
from .moe import MoECfg, capacity, init_moe, moe_aux_loss, moe_ffn, moe_route
from .norms import layer_norm, rms_norm
from .rotary import apply_rope, rope_freqs
