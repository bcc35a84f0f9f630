"""vertexSubset (Ligra §2) — a frontier over the vertices.

The canonical representation is a dense bool[n] mask: exactly the paper's
"dense" frontier, O(n) *bits* of small memory.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VertexSubset:
    mask: torch.Tensor  # bool[n]
    n: int

    @property
    def size(self) -> int:
        return int(self.mask.sum())


def from_indices(n: int, idx, device) -> VertexSubset:
    """Frontier from a vertex-id list (out-of-range ids drop silently)."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=device).reshape(-1)
    idx = idx[(idx >= 0) & (idx < n)]
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[idx] = True
    return VertexSubset(mask=mask, n=n)
