"""equiformer-v2 [gnn] n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8
equivariance=SO(2)-eSCN  [arXiv:2306.12059; unverified]"""
from __future__ import annotations

from ..models.gnn import equiformer_v2 as mod
from .gnn_common import gnn_cells, gnn_smoke_batch

ARCH_ID = "equiformer-v2"
FAMILY = "gnn"
MODULE = mod


def full_config():
    return mod.EquiformerV2Config(
        name=ARCH_ID, n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8,
    )


def smoke_config():
    return mod.EquiformerV2Config(
        name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16, l_max=2, m_max=1,
        n_heads=2, d_in=16, task="graph", n_graphs=4,
    )


def _flops(cfg, n, e):
    d, Cf = cfg.d_hidden, cfg.n_coef
    per_layer = e * (Cf * d * d * (2 * cfg.m_max + 1) / Cf + Cf * d) + n * (4 * d * d)
    return 3.0 * 2 * cfg.n_layers * per_layer


def cells():
    return gnn_cells(ARCH_ID, mod, full_config(), with_pos=True,
                     with_triplets=False, flops_fn=_flops)


def smoke_batch(seed=0, *, device=None):
    return gnn_smoke_batch(seed, device=device, with_pos=True, task="graph", n_graphs=4)
