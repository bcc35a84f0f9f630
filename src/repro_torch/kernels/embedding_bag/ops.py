"""Public EmbeddingBag ops: bag sums and means, and row lookups as bags of one."""
from __future__ import annotations

import torch

from .embedding_bag import embedding_bag_sums


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None, *, mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag over fixed-width bags padded with negative ids: ``sum``
    or ``mean`` of the (weighted) rows.  As in the JAX package's op, the
    mean divides by the count of ids ``>= 0`` (an id ``>= V`` adds nothing
    but counts), taken and divided in the table's dtype, at least 1."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    out = embedding_bag_sums(table, indices, weights)
    if mode == "mean":
        cnt = (indices >= 0).to(table.dtype).sum(dim=1, keepdim=True)
        out = out / torch.clamp_min(cnt, 1)
    return out


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0, mode="fill", fill_value=0)``: rows of
    ``table`` (V, D) at ``ids`` of any shape → ``ids.shape + (D,)``.

    Ids in ``[-V, -1]`` wrap to ``id + V``, as ``jnp.take`` wraps them; ids
    below ``-V`` or at least ``V`` give zero rows.  Every id is a bag of one
    with weight 1 of the EmbeddingBag kernel, so a row comes back exactly."""
    V, D = table.shape
    flat = ids.reshape(-1, 1)
    flat = torch.where(flat < 0, flat + V, flat)
    if flat.dtype != torch.int32:  # out-of-range int64 ids must not wrap into range
        flat = flat.clamp(-1, V).to(torch.int32)
    return embedding_bag_sums(table, flat.contiguous()).reshape(*ids.shape, D)
