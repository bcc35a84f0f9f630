"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq  [arXiv:1808.09781; paper]

Catalog fixed at 2^20 items (row-shardable by every mesh).  Shapes:
train_batch 65,536 (training) · serve_p99 512 (online) · serve_bulk 262,144
(offline scoring, top-k output) · retrieval_cand 1×1,000,000 (padded to
1,000,448 = 512·1954) — batched dot against the sharded candidate rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.shardings import RECSYS_RETRIEVAL_RULES, RECSYS_RULES
from ..models import sasrec as mod
from .common import Cell, i32

ARCH_ID = "sasrec"
FAMILY = "recsys"
MODULE = mod

VOCAB = 1 << 20
N_CAND = 1_000_448  # 1M padded to ×512

def full_config() -> mod.SASRecConfig:
    return mod.SASRecConfig(name=ARCH_ID, vocab=VOCAB, embed_dim=50,
                            n_blocks=2, n_heads=1, seq_len=50)


def smoke_config() -> mod.SASRecConfig:
    return mod.SASRecConfig(name=ARCH_ID + "-smoke", vocab=512, embed_dim=16,
                            n_blocks=2, n_heads=1, seq_len=10, kv_block=8)


def _flops(cfg, batch, kind):
    d, L = cfg.embed_dim, cfg.seq_len
    enc = batch * L * d * d * 8 + batch * L * L * d * 2 * cfg.n_blocks
    if kind == "train":
        return 3.0 * (2 * enc + 2 * batch * L * d * 2)
    if kind == "retrieval":
        return 2.0 * enc + 2.0 * batch * N_CAND * d
    return 2.0 * enc + 2.0 * batch * cfg.vocab * d


def cells():
    cfg = full_config()
    L = cfg.seq_len
    out = {}
    out["train_batch"] = Cell(
        arch=ARCH_ID, shape="train_batch", kind="train", family="recsys",
        model_cfg=cfg,
        batch_specs={"seq": i32(65536, L), "pos": i32(65536, L), "neg": i32(65536, L)},
        batch_logical={"seq": ("batch", None), "pos": ("batch", None), "neg": ("batch", None)},
        rules=RECSYS_RULES,
        model_flops=_flops(cfg, 65536, "train"),
    )
    for shape, b in [("serve_p99", 512), ("serve_bulk", 262144)]:
        out[shape] = Cell(
            arch=ARCH_ID, shape=shape, kind="serve", family="recsys",
            model_cfg=cfg,
            batch_specs={"seq": i32(b, L)},
            batch_logical={"seq": ("batch", None)},
            rules=RECSYS_RULES,
            notes="full-catalog scoring; top-100 output (bulk scorers emit top-k)",
            model_flops=_flops(cfg, b, "serve"),
        )
    out["retrieval_cand"] = Cell(
        arch=ARCH_ID, shape="retrieval_cand", kind="retrieval", family="recsys",
        model_cfg=cfg,
        batch_specs={"seq": i32(1, L), "candidates": i32(1, N_CAND)},
        batch_logical={"seq": (None, None), "candidates": (None, "candidates")},
        rules=RECSYS_RETRIEVAL_RULES,
        model_flops=_flops(cfg, 1, "retrieval"),
    )
    return out


def smoke_batch(seed: int = 0, *, device=None) -> dict:
    """The JAX package's ``smoke_batch(seed)``, the same numpy draws, as
    int32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cfg = smoke_config()
    draws = {
        "seq": rng.integers(0, cfg.vocab, (4, cfg.seq_len)),
        "pos": rng.integers(1, cfg.vocab, (4, cfg.seq_len)),
        "neg": rng.integers(1, cfg.vocab, (4, cfg.seq_len)),
        "candidates": rng.integers(0, cfg.vocab, (4, 64)),
    }
    return {k: torch.from_numpy(v.astype(np.int32)).to(dev) for k, v in draws.items()}
