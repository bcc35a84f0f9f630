"""pna [gnn] n_layers=4 d_hidden=75 aggregators=mean-max-min-std
scalers=id-amp-atten  [arXiv:2004.05718; paper]"""
from __future__ import annotations

from ..models.gnn import pna as mod
from .gnn_common import gnn_cells, gnn_smoke_batch

ARCH_ID = "pna"
FAMILY = "gnn"
MODULE = mod


def full_config():
    return mod.PNAConfig(name=ARCH_ID, n_layers=4, d_hidden=75)


def smoke_config():
    return mod.PNAConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16,
                         d_in=16, n_classes=8, task="node")


def _flops(cfg, n, e):
    d = cfg.d_hidden
    per_layer = e * (2 * d * d * 2) + n * (12 * d * d + 2 * 2 * d * d)
    return 3.0 * 2 * cfg.n_layers * per_layer  # fwd+bwd


def cells():
    return gnn_cells(ARCH_ID, mod, full_config(), with_pos=False,
                     with_triplets=False, flops_fn=_flops)


def smoke_batch(seed=0, *, device=None):
    return gnn_smoke_batch(seed, device=device, task="node", n_classes=8)
