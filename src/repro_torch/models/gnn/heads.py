"""Losses the GNN models share: the JAX package's squared error and masked
cross-entropy."""
from __future__ import annotations

import torch

from .aggregate import maximum


def mse(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - tgt.float()) ** 2)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows whose label is >= 0 (float32
    logits); 0 when none is."""
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long().clamp_min(0)[:, None])[:, 0]
    return torch.sum((lse - tgt) * mask) / maximum(torch.sum(mask), 1.0)
