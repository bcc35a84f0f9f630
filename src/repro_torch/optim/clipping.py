"""Global-norm gradient clipping, as the JAX package's ``optim/clipping.py``."""
from __future__ import annotations

import torch

from .tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together, in float32 (0-d)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """``(grads scaled by min(1, max_norm / norm), norm)``: each gradient is
    scaled in float32 and cast back to its own dtype."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn
