"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq  [arXiv:1808.09781; paper]

Catalog fixed at 2^20 items.  Serving shapes: serve_p99 512 users
(online), serve_bulk 262,144 (offline scoring, top-k output),
retrieval_cand 1 × 1,000,000 candidates (padded to 1,000,448 = 512·1954).
The JAX package's ``Cell``s and sharding rules stay there: ``SHAPES``
holds the serving shapes as plain data.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import sasrec as mod

ARCH_ID = "sasrec"
FAMILY = "recsys"
MODULE = mod

VOCAB = 1 << 20
N_CAND = 1_000_448  # 1M padded to ×512

SHAPES = {  # serving cells: users a batch, and candidates a query
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1, "n_candidates": N_CAND},
}


def full_config() -> mod.SASRecConfig:
    return mod.SASRecConfig(name=ARCH_ID, vocab=VOCAB, embed_dim=50,
                            n_blocks=2, n_heads=1, seq_len=50)


def smoke_config() -> mod.SASRecConfig:
    return mod.SASRecConfig(name=ARCH_ID + "-smoke", vocab=512, embed_dim=16,
                            n_blocks=2, n_heads=1, seq_len=10, kv_block=8)


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
