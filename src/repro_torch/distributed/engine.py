"""Edge-partitioned graph engine — thin planner specializations.

The immutable edge blocks are *sharded* as contiguous ranges over a
``ShardMesh``; the O(n) vertex state is *replicated* and combined once per
edgeMap round.  Cross-shard traffic per round is O(n) words — never O(m) —
the PSAM small-memory bound expressed as a communication bound.

This module owns no edge-iteration body: every function builds an
``ExecutionPlan`` and runs the same ``edgemap_reduce`` the single-device
path runs, through the sharded executor.  Prepare a graph once with
``prepare_sharded`` (or ``ExecutionPlan.prepare``) and pass the
``ShardedGraph`` to the returned functions.
"""
from __future__ import annotations

import torch

from ..core.csr import sharded_block_counts
from ..core.edgemap import edgemap_reduce
from ..core.plan import ExecutionPlan, make_plan


def _weighted(xs, w):
    return xs * w


def _sharded_plan(mesh, **knobs) -> ExecutionPlan:
    """A dense plan over ``mesh``, its route from the mesh's first device."""
    return make_plan(mesh=mesh, strategy="dense", tuning=None, **knobs)


def prepare_sharded(mesh, g, *, shard_axes: tuple = ()):
    """Shard and place ``g`` (``CSRGraph`` | ``CompressedCSR``) on ``mesh``."""
    return make_plan(g, mesh=mesh, shard_axes=shard_axes, tuning=None).prepare(g)


def distributed_vertex_reduce(
    mesh, *, n: int, monoid: str = "sum", mode: str = "flat", state_dtype=None
):
    """Build ``fn(gs, x) -> out``: one full-frontier weighted edgeMap round,
    ``out[v]`` = monoid over the edges (u, v) of ``x[u] * w_uv``.

    ``gs`` is a ``ShardedGraph`` prepared over every mesh axis; ``x`` and
    the output are replicated.  ``mode`` is the sum combine: ``"flat"``
    (every axis in turn) or ``"hierarchical"`` (the fast axis first, then
    the slow ones); ``state_dtype`` (e.g. ``torch.bfloat16``) is the dtype
    the sum is combined in."""
    plan = _sharded_plan(mesh, reduce_mode=mode, state_dtype=state_dtype)

    def fn(gs, x):
        out, _ = edgemap_reduce(
            gs, torch.ones(n, dtype=torch.bool, device=x.device), x, monoid=monoid,
            map_fn=_weighted, mode="dense", plan=plan,
        )
        return out.to(x.dtype)

    return fn


def distributed_pagerank_step(
    mesh, *, n: int, damping: float = 0.85, mode: str = "flat", state_dtype=None
):
    """One PageRank iteration over sharded edges:
    ``step(gs, pr, inv_deg) = (1 - d) / n + d · Σ_in w · pr · inv_deg``."""
    reduce_fn = distributed_vertex_reduce(mesh, n=n, mode=mode, state_dtype=state_dtype)

    def step(gs, pr, inv_deg):
        s = reduce_fn(gs, pr * inv_deg)
        return (1.0 - damping) / n + damping * s

    return step


def distributed_frontier_min(mesh, *, n: int):
    """BFS / label-propagation round: ``out[v]`` = min over the active edges
    into v of ``x[src]``, frontier-masked; untouched vertices come back as
    the min identity (int32 max)."""
    plan = _sharded_plan(mesh)

    def fn(gs, x, frontier):
        out, _ = edgemap_reduce(gs, frontier, x, monoid="min", mode="dense", plan=plan)
        return out

    return fn


def shard_blocks_for_mesh(mesh, num_blocks: int, shard_axes: tuple = ()) -> int:
    """Padded per-mesh block count: the least multiple of the sharded axes'
    product ≥ ``num_blocks`` (the tail pads with empty blocks, never
    truncated).  ``shard_axes`` picks the axes (default: all of them)."""
    total = 1
    for ax in tuple(shard_axes) or tuple(mesh.axis_names):
        total *= mesh.axis_size(ax)
    return sharded_block_counts(num_blocks, total)[1]
