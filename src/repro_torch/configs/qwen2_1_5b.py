"""qwen2-1.5b [dense] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias  [arXiv:2407.10671; hf]"""
from __future__ import annotations

from ..models import transformer_lm as lm
from .lm_common import lm_cells, lm_smoke_batch

ARCH_ID = "qwen2-1.5b"
FAMILY = "lm"
MODULE = lm


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_head=128,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        dtype="bfloat16",
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_head=8,
        d_ff=96,
        vocab=128,
        qkv_bias=True,
        dtype="float32",
        kv_block=16,
    )


def cells():
    return lm_cells(full_config())


def smoke_batch(generator, *, device=None):
    return lm_smoke_batch(smoke_config(), generator, device=device)
