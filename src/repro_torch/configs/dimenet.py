"""dimenet [gnn] n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6  [arXiv:2003.03123; unverified]"""
from __future__ import annotations

from ..models.gnn import dimenet as mod
from .gnn_common import gnn_cells, gnn_smoke_batch

ARCH_ID = "dimenet"
FAMILY = "gnn"
MODULE = mod


def full_config():
    return mod.DimeNetConfig(
        name=ARCH_ID, n_blocks=6, d_hidden=128, n_bilinear=8,
        n_spherical=7, n_radial=6,
    )


def smoke_config():
    return mod.DimeNetConfig(
        name=ARCH_ID + "-smoke", n_blocks=2, d_hidden=16, n_bilinear=4,
        n_spherical=3, n_radial=3, d_in=16, task="graph", n_graphs=4,
    )


def _flops(cfg, n, e):
    d, nb = cfg.d_hidden, cfg.n_bilinear
    t = e * 4  # representative triplet multiplicity
    per_block = t * (d * nb + nb * d) + e * (d * d * 3)
    return 3.0 * 2 * cfg.n_blocks * per_block


def cells():
    return gnn_cells(ARCH_ID, mod, full_config(), with_pos=True,
                     with_triplets=True, flops_fn=_flops)


def smoke_batch(seed=0, *, device=None):
    return gnn_smoke_batch(seed, device=device, with_pos=True, with_triplets=True,
                           task="graph", n_graphs=4)
