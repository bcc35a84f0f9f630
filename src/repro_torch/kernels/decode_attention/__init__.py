from .decode_attention import decode_attention
from .ref import ATTN_REL_TOL, decode_attention_ref, decode_attention_rel_err
