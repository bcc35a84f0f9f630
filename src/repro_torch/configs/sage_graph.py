"""The paper's own workload: Sage graph analytics over the PSAM engine.

Not part of the assigned 40-cell grid, but the reproduction's native
configs: RMAT graphs standing in for the paper's web/social inputs, and the
distributed (edge-partitioned) engine cells (the JAX package's
``configs/sage_graph.py``)."""
from __future__ import annotations

import dataclasses

from ..distributed.shardings import GRAPH_ENGINE_RULES

ARCH_ID = "sage-graph"
FAMILY = "graph"


@dataclasses.dataclass(frozen=True)
class SageGraphConfig:
    name: str = ARCH_ID
    n: int = 1 << 20                # vertices
    m: int = 1 << 24                # directed edges (×2 after symmetrize)
    block_size: int = 128           # F_B, = filter block size
    weighted: bool = True


def full_config():
    # stand-in scale for the paper's inputs, shardable by 512 blocks
    return SageGraphConfig()


def smoke_config():
    return SageGraphConfig(name=ARCH_ID + "-smoke", n=128, m=512, block_size=32)


RULES = GRAPH_ENGINE_RULES
