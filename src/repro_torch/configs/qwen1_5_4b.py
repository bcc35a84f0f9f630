"""qwen1.5-4b [dense] 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936 — QKV bias  [hf:Qwen/Qwen1.5-4B; hf]"""
from __future__ import annotations

from ..models import transformer_lm as lm

ARCH_ID = "qwen1.5-4b"
FAMILY = "lm"
MODULE = lm


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID,
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_head=128,
        d_ff=6912,
        vocab=151936,
        qkv_bias=True,
        dtype="bfloat16",
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=40,
        n_heads=5,
        n_kv_heads=5,
        d_head=8,
        d_ff=80,
        vocab=128,
        qkv_bias=True,
        dtype="float32",
        kv_block=16,
    )

