"""Plain PyTorch version of the EmbeddingBag kernel.

``embedding_bag_ref`` has the signature of the kernel wrapper
(``embedding_bag.embedding_bag_sums``) and of the JAX package's oracle, and
computes the same function with ordinary tensor ops: the CPU route runs
it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

It repeats the kernel's arithmetic: the weights are rounded to the table's
dtype, each slot's product and the running sum are float32, added slot by
slot in order, and the sum is rounded once to the table's dtype.

``bag_case``, ``bag_of_one_case``, ``bf16_ulps`` and ``same_bits`` are
what the card tests and ``chip_smoke.py`` share to hold the kernel to this
version: the inputs, with padding and out-of-range ids (and a -0.0)
planted, the bfloat16 distance and bit-for-bit equality.
"""
from __future__ import annotations

import numpy as np
import torch


def embedding_bag_ref(table, indices, weights=None):
    """``table`` (V, D), ``indices`` (B, L) integer ids, ``weights`` (B, L)
    or None (every weight 1) → (B, D) weighted bag sums in ``table.dtype``.

    A slot is valid when ``0 <= id < V``; any other id is padding and adds
    exactly 0: neither its row nor its weight reaches the sum (a NaN weight
    on a padding slot leaves the sum finite)."""
    V, D = table.shape
    B, L = indices.shape
    valid = (indices >= 0) & (indices < V)
    safe = torch.where(valid, indices, 0).long()
    w = None if weights is None else weights.to(table.dtype).float()
    acc = torch.zeros((B, D), dtype=torch.float32, device=table.device)
    for s in range(L):
        term = table[safe[:, s]].float()
        if w is not None:
            term = term * w[:, s, None]
        acc = acc + torch.where(valid[:, s, None], term, 0.0)
    return acc.to(table.dtype)


def bag_case(V, D, B, L, dtype=torch.float32, seed=0, device="cpu"):
    """A normal (V, D) table of ``dtype``, (B, L) int32 ids in [-1, V) with
    -1, -7, V and V+3 planted at random slots, and normal (B, L) weights of
    ``dtype`` with a NaN on one padding slot; drawn with numpy from
    ``seed``, then placed on ``device``."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(dtype)
    idx = rng.integers(-1, V, (B, L)).astype(np.int32)
    slots = rng.choice(B * L, min(5, B * L), replace=False)
    idx.flat[slots] = [-1, -7, V, V + 3, -1][:len(slots)]
    w = rng.standard_normal((B, L)).astype(np.float32)
    w.flat[slots[-1]] = np.nan
    return (table.to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(w).to(dtype).to(device))


def bag_of_one_case(V, D, B, dtype=torch.float32, seed=0, device="cpu"):
    """Bags of one, as ``take_rows`` makes them: a normal (V, D) table of
    ``dtype`` with -0.0 in every third element of the first bag's row,
    (B, 1) int32 ids in [0, V) with -1, -7, V and V+3 planted after the
    first bag (as many as fit), and normal (B, 1) weights of ``dtype`` with
    a NaN on the last planted slot; drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, 1)).astype(np.int32)
    planted = [-1, -7, V, V + 3][: max(B - 1, 0)]
    slots = 1 + rng.choice(B - 1, len(planted), replace=False) if planted else []
    idx[slots, 0] = planted
    table[idx[0, 0], ::3] = -0.0
    w = rng.standard_normal((B, 1)).astype(np.float32)
    if planted:
        w[slots[-1], 0] = np.nan
    return (torch.from_numpy(table).to(dtype).to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(w).to(dtype).to(device))


def same_bits(got, want) -> bool:
    """Bit for bit equal, so -0.0 differs from +0.0 (``torch.equal`` does not
    tell them apart) and a NaN equals the same NaN."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[want.dtype]
    return bool(torch.equal(got.contiguous().view(view), want.contiguous().view(view)))


def bf16_ulps(got, want):
    """bfloat16 distance of ``got`` from ``want`` in units in the last
    place, element by element (0 for equal values, 1 for neighbours)."""
    def key(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -32768 - b, b)

    return (key(got) - key(want)).abs()
