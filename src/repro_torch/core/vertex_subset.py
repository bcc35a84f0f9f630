"""vertexSubset (Ligra §2) — a frontier over the vertices.

The canonical representation is a dense bool[n] mask: exactly the paper's
"dense" frontier, O(n) *bits* of small memory.  A sparse (index) view is
derived on demand with ``compact_mask`` and is still O(n) words.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .primitives import compact_mask


@dataclasses.dataclass(frozen=True)
class VertexSubset:
    mask: torch.Tensor  # bool[n]
    n: int

    @property
    def size(self) -> int:
        return int(self.mask.sum())

    def is_empty(self) -> torch.Tensor:
        return ~self.mask.any()

    def to_indices(self):
        """(ids int64[n] padded with n, count as a Python int)."""
        return compact_mask(self.mask)


def from_indices(n: int, idx, device=None) -> VertexSubset:
    """Frontier from a vertex-id list on ``device`` (default ``cuda``): ids in
    [-n, -1] wrap to n + id, as an indexed store does; every other
    out-of-range id drops silently."""
    dev = resolve_device(device)
    idx = torch.as_tensor(idx, dtype=torch.int64).reshape(-1).to(dev)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = idx[(idx >= 0) & (idx < n)]
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[idx] = True
    return VertexSubset(mask=mask, n=n)


def from_mask(mask) -> VertexSubset:
    """Frontier from an existing bool[n] membership mask, on its device."""
    mask = torch.as_tensor(mask).to(torch.bool)
    return VertexSubset(mask=mask, n=mask.shape[0])


def full(n: int, device=None) -> VertexSubset:
    """The all-vertices frontier (dense passes, e.g. PageRank rounds)."""
    return VertexSubset(mask=torch.ones(n, dtype=torch.bool, device=resolve_device(device)),
                        n=n)


def empty(n: int, device=None) -> VertexSubset:
    """The empty frontier (the loop-termination fixpoint)."""
    return VertexSubset(mask=torch.zeros(n, dtype=torch.bool, device=resolve_device(device)),
                        n=n)
