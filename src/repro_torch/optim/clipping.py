"""Global-norm gradient clipping, as the JAX package's ``optim/clipping.py``;
on a ``ProcessMesh`` over the ranks' blocks of the gradient."""
from __future__ import annotations

import torch
import torch.distributed as dist

from .tree import tree_leaves, tree_map


def _sum_over(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``t`` summed in place over the mesh ``axes``: one all-reduce, on the
    mesh's group where they are all its axes of more than one rank."""
    if set(axes) == {a for a in mesh.axis_names if mesh.axis_size(a) > 1}:
        dist.all_reduce(t, group=mesh.group)
        return t
    for a in axes:
        dist.all_reduce(t, group=mesh.axis_groups[a])
    return t


def global_norm(tree, mesh=None, axes=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together, in float32 (0-d).

    On a process mesh ``tree`` holds the rank's blocks and ``axes`` lists,
    in walk order, the mesh axes each leaf is split over: the squares are
    summed on the blocks, one sum for each set of axes, and each sum is
    added over its axes alone, so a leaf replicated over an axis counts
    once.  Every rank gets the same norm."""
    leaves = tree_leaves(tree)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
    sums = {}
    for x, split in zip(leaves, axes, strict=True):
        key = tuple(a for a in mesh.axis_names if a in split and mesh.axis_size(a) > 1)
        sums[key] = sums.get(key, 0) + torch.sum(torch.square(x.float()))
    for key in sums:
        if key:
            _sum_over(sums[key], mesh, key)
    return torch.sqrt(sum(sums[k] for k in sorted(sums)))


def clip_by_global_norm(grads, max_norm: float = 1.0, mesh=None, axes=None):
    """``(grads scaled by min(1, max_norm / norm), norm)``: each gradient is
    scaled in float32 and cast back to its own dtype; ``mesh`` and ``axes``
    as ``global_norm`` takes them."""
    gn = global_norm(grads, mesh, axes)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn
