"""Elastic scaling: carve a process mesh from the live ranks and restore
state onto it, as the JAX package's ``distributed/elastic.py``.

Every placement in the port is a ``PartitionSpec`` over *named* axes, never
ranks, so shrinking or growing a job is: carve a new mesh, resolve the same
logical rules on it, and restore the newest checkpoint as each rank's
blocks.  The checkpoint format holds global leaves (``checkpoint/ckpt.py``),
so it does not depend on the mesh that wrote it.
"""
from __future__ import annotations

import torch.distributed as dist

from ..checkpoint.ckpt import restore_latest
from ..core.mesh import ProcessMesh, make_process_mesh
from ..optim.tree import tree_map
from .shardings import axis_rules, shard_tree, spec_tree


def carve_shape(n: int, *, max_model: int = 16) -> tuple[int, int]:
    """``(data, model)`` for ``n`` ranks: ``model`` the largest power of two
    at most ``max_model`` that divides ``n`` (tensor parallelism wants the
    fast axis), ``data`` the rest."""
    model = 1
    while model * 2 <= max_model and n % (model * 2) == 0:
        model *= 2
    return n // model, model


def carve_mesh(n: int | None = None, *, max_model: int = 16, group=None,
               device=None) -> ProcessMesh:
    """A ``("data", "model")`` ``ProcessMesh`` of ``carve_shape(n)`` over
    ``group`` (None: the default group), ``n`` its size by default.  Every
    rank of the group calls it (``make_process_mesh``); ``n`` other than the
    group's size raises."""
    n = n or dist.get_world_size(group)
    return make_process_mesh(carve_shape(n, max_model=max_model), ("data", "model"),
                             group=group, device=device)


def elastic_restore(ckpt_dir: str, example_tree, logical_tree, rules, mesh: ProcessMesh):
    """``(tree, step)``: the newest checkpoint of ``ckpt_dir`` as this
    rank's blocks on ``mesh`` (any shape) under ``rules``, on the mesh's
    device; ``(None, None)`` if there is none.  ``example_tree`` gives the
    global structure and dtypes (meta tensors will do), ``logical_tree``
    every leaf's logical axes.  Each rank reads the checkpoint on the host
    and keeps its block; no collective runs."""
    with axis_rules(rules, mesh):
        specs = spec_tree(logical_tree)
    tree, step = restore_latest(ckpt_dir, example_tree, device="cpu")
    if tree is None:
        return None, None
    blocks = shard_tree(tree, specs, mesh)
    return tree_map(lambda t: t.to(mesh.device, copy=True), blocks), step
