"""deepseek-v2-lite-16b [moe] 27L d_model=2048 16H d_ff=1408 (per routed
expert) vocab=102400, MoE 64e top-6 — MLA kv_lora=512, 2 shared experts,
first layer dense (d_ff 10944)  [arXiv:2405.04434; hf]"""
from __future__ import annotations

from ..models import transformer_lm as lm
from .lm_common import lm_cells, lm_smoke_batch

ARCH_ID = "deepseek-v2-lite-16b"
FAMILY = "lm"
MODULE = lm


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID,
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=192,          # nope 128 + rope 64 (decomposed below)
        d_ff=10944,          # the first (dense) layer
        vocab=102400,
        attn="mla",
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        moe=True,
        num_experts=64,
        top_k=6,
        n_shared=2,
        d_ff_expert=1408,
        first_dense_layers=1,
        rope_theta=10_000.0,
        dtype="bfloat16",
    )


def smoke_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=3,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        vocab=128,
        attn="mla",
        kv_lora_rank=16,
        rope_head_dim=8,
        nope_head_dim=8,
        v_head_dim=8,
        moe=True,
        num_experts=8,
        top_k=2,
        n_shared=1,
        d_ff_expert=16,
        first_dense_layers=1,
        dtype="float32",
        kv_block=16,
    )


def cells():
    return lm_cells(full_config())


def smoke_batch(generator, *, device=None):
    return lm_smoke_batch(smoke_config(), generator, device=device)
