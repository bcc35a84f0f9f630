"""Synthetic graph generation — RMAT power-law graphs (the standard stand-in
for the paper's web/social inputs) plus structured graphs for tests.

Host-side numpy draws, identical to the JAX package's for the same seed;
the graph is then placed on ``device`` (default ``cuda``).  Weights are
drawn uniformly from [1, log2 n) as in §5.1.3.
"""
from __future__ import annotations

import numpy as np

from ..core.csr import CSRGraph, build_csr


def rmat_edges(
    n: int,
    m: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT edge generator (Chakrabarti et al.); n must be a power of two
    (rounded up internally)."""
    rng = np.random.default_rng(seed)
    levels = max(1, int(np.ceil(np.log2(max(n, 2)))))
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    p = np.array([a, b, c, 1.0 - a - b - c])
    for _ in range(levels):
        q = rng.choice(4, size=m, p=p)
        src = src * 2 + (q >= 2)
        dst = dst * 2 + (q % 2)
    src, dst = src % n, dst % n
    return src, dst


def rmat_weights(n: int, count: int, seed: int = 0) -> np.ndarray:
    """The integer edge weights ``rmat_graph`` draws, as float32."""
    rng = np.random.default_rng(seed + 1)
    hi = max(2, int(np.log2(max(n, 4))))
    return rng.integers(1, hi, size=count).astype(np.float32)


def rmat_graph(
    n: int,
    m: int,
    *,
    weighted: bool = False,
    seed: int = 0,
    block_size: int = 128,
    device=None,
) -> CSRGraph:
    src, dst = rmat_edges(n, m, seed=seed)
    w = rmat_weights(n, src.shape[0], seed) if weighted else None
    return build_csr(n, src, dst, w, symmetrize=True, block_size=block_size, device=device)


def structured_graph(
    kind: str, *, block_size: int = 32, weighted: bool = False, device=None
) -> CSRGraph:
    """Small deterministic graphs for unit tests."""
    if kind == "path":  # 0-1-2-...-9
        src = np.arange(9)
        dst = np.arange(1, 10)
        n = 10
    elif kind == "star":  # hub 0
        src = np.zeros(8, dtype=np.int64)
        dst = np.arange(1, 9)
        n = 9
    elif kind == "cycle":
        n = 8
        src = np.arange(n)
        dst = (np.arange(n) + 1) % n
    elif kind == "grid":  # 4x4 grid
        n = 16
        ss, dd = [], []
        for r in range(4):
            for cc in range(4):
                v = r * 4 + cc
                if cc < 3:
                    ss.append(v), dd.append(v + 1)
                if r < 3:
                    ss.append(v), dd.append(v + 4)
        src, dst = np.array(ss), np.array(dd)
    elif kind == "two_triangles":  # {0,1,2} and {3,4,5}, disconnected
        src = np.array([0, 1, 2, 3, 4, 5])
        dst = np.array([1, 2, 0, 4, 5, 3])
        n = 6
    elif kind == "barbell":  # two triangles joined by a bridge 2-3
        src = np.array([0, 1, 2, 2, 3, 4, 5])
        dst = np.array([1, 2, 0, 3, 4, 5, 3])
        n = 6
    else:
        raise ValueError(kind)
    w = None
    if weighted:
        rng = np.random.default_rng(0)
        w = rng.integers(1, 5, size=src.shape[0]).astype(np.float32)
    return build_csr(n, src, dst, w, symmetrize=True, block_size=block_size, device=device)
