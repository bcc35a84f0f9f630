"""dbrx-132b [moe] 40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert)
vocab=100352, MoE 16e top-4 fine-grained  [hf:databricks/dbrx-base; unverified]"""
from __future__ import annotations

from ..models import transformer_lm as lm
from .lm_common import lm_cells, lm_smoke_batch

ARCH_ID = "dbrx-132b"
FAMILY = "lm"
MODULE = lm


def full_config() -> lm.LMConfig:
    return lm.LMConfig(
        name=ARCH_ID,
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=10752,
        vocab=100352,
        moe=True,
        num_experts=16,
        top_k=4,
        d_ff_expert=10752,
        rope_theta=500_000.0,
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
        d_ff=64,
        vocab=128,
        moe=True,
        num_experts=4,
        top_k=2,
        d_ff_expert=64,
        dtype="float32",
        kv_block=16,
    )


def cells():
    return lm_cells(full_config())


def smoke_batch(generator, *, device=None):
    return lm_smoke_batch(smoke_config(), generator, device=device)
