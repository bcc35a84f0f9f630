"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826; paper]"""
from __future__ import annotations

from ..models.gnn import gin as mod
from .gnn_common import gnn_cells, gnn_smoke_batch

ARCH_ID = "gin-tu"
FAMILY = "gnn"
MODULE = mod


def full_config():
    return mod.GINConfig(name=ARCH_ID, n_layers=5, d_hidden=64)


def smoke_config():
    return mod.GINConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16,
                         d_in=16, n_classes=1, task="graph", n_graphs=4)


def _flops(cfg, n, e):
    d = cfg.d_hidden
    per_layer = e * d + n * (2 * d * 2 * d * 2)
    return 3.0 * 2 * cfg.n_layers * per_layer


def cells():
    return gnn_cells(ARCH_ID, mod, full_config(), with_pos=False,
                     with_triplets=False, flops_fn=_flops)


def smoke_batch(seed=0, *, device=None):
    return gnn_smoke_batch(seed, device=device, task="graph", n_graphs=4)
