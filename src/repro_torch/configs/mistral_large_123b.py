"""mistral-large-123b [dense] 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from __future__ import annotations

from ..models import transformer_lm as lm
from .lm_common import lm_cells, lm_smoke_batch

ARCH_ID = "mistral-large-123b"
FAMILY = "lm"
MODULE = lm


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID,
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_head=128,
        d_ff=28672,
        vocab=32768,
        rope_theta=1_000_000.0,
        dtype="bfloat16",
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=128,
        vocab=256,
        dtype="float32",
        kv_block=16,
    )


def cells():
    return lm_cells(full_config())


def smoke_batch(generator, *, device=None):
    return lm_smoke_batch(smoke_config(), generator, device=device)
