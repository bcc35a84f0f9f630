"""Registry of the 10 assigned architectures (+ the paper's own graph
workload), each config a copy of its JAX module's ``ARCH_ID``, ``FAMILY``,
``MODULE``, ``full_config()``, ``smoke_config()``, ``cells()`` and
``smoke_batch``.  ``get_arch(name)`` → config module; ``all_cells()`` → the
full 40-cell (arch × shape) grid; ``GNN_ARCHS`` the four GNNs."""
from __future__ import annotations

from . import (
    dbrx_132b,
    deepseek_v2_lite_16b,
    dimenet,
    equiformer_v2,
    gin_tu,
    mistral_large_123b,
    pna,
    qwen1_5_4b,
    qwen2_1_5b,
    sage_graph,
    sasrec,
)

ARCHS = {
    m.ARCH_ID: m
    for m in [
        mistral_large_123b,
        qwen2_1_5b,
        qwen1_5_4b,
        dbrx_132b,
        deepseek_v2_lite_16b,
        pna,
        dimenet,
        equiformer_v2,
        gin_tu,
        sasrec,
    ]
}

GNN_ARCHS = {m.ARCH_ID: m for m in (pna, dimenet, equiformer_v2, gin_tu)}


def get_arch(name: str):
    return ARCHS[name]


def all_cells():
    """The 40 (architecture × shape) cells."""
    out = {}
    for name, m in ARCHS.items():
        for shape, cell in m.cells().items():
            out[(name, shape)] = cell
    return out


__all__ = ["ARCHS", "GNN_ARCHS", "all_cells", "get_arch", "sage_graph"]
