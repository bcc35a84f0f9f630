"""Logical-axis sharding rules (MaxText-style): the JAX package's tables,
the functions that apply them, and the placement of a tensor's blocks on a
process mesh.

Models annotate tensors with *logical* axis names; a rule set maps logical
names to mesh axis names for the active mesh.  The same model code runs on
one device (rules inactive: every spec replicated) and on a
``ProcessMesh`` (one block of every sharded tensor a rank).  Rule sets per
family:

* LM_RULES      — Megatron TP: heads/ff/vocab/experts → 'model';
                  batch → ('pod','data'); residual activations replicated
                  over 'model'.
* LM_RULES_SP   — + sequence parallelism: the residual stream's 'seq' axis
                  is sharded over 'model' between blocks.
* GNN_RULES     — edge/node arrays sharded over the flattened data×model
                  axes (edge partitioning); feature dims replicated.
* RECSYS_RULES  — embedding-table rows → 'model' (EP), batch → data axes.
* GRAPH_ENGINE_RULES — Sage engine: blocks → ('data','model'), vertex state
                  replicated.

The functions, with the JAX package's semantics:

  axis_rules(rules, mesh)    — a context that activates a rule set (and the
                               mesh's axis names as a filter)
  logical_to_spec(*names)    — a ``PartitionSpec``: a target axis the mesh
                               lacks is dropped, a tuple target keeps its
                               surviving axes as a tuple, inactive rules
                               replicate
  constrain(x, *names)       — ``x`` itself (see its docstring)
  spec_tree(logical_tree)    — every tuple leaf of a tree through
                               ``logical_to_spec``

Placement on a ``ProcessMesh`` (one process a mesh position):

  shard_block(x, spec, mesh)                 — this rank's block of a global tensor
  gather_blocks(block, spec, shape, mesh)    — the global tensor, all-gathered
  gather_over(block, spec, mesh, axes)       — the block gathered over ``axes`` only
  reduce_scatter_blocks(t, spec, mesh, axes) — its inverse: ``t`` summed over
                                               ``axes`` into the rank's block
  shard_tree / gather_tree                   — the same over trees

Dim d splits over the spec's axes at d into equal contiguous parts; the
rank's part is the row-major digits of its coordinates on those axes, the
first axis the slowest (``ProcessMesh.shard_index``).  A gather moves
bytes: every block is all-gathered as ``uint8`` over the axis groups
(``ProcessMesh.axis_groups``), so it needs no dtype of the backend's own
(gloo's ``all_gather`` refuses int16, for one).  Under gloo the gathers run
on CUDA tensors as they are: no host staging (gloo takes CUDA tensors in
``all_gather`` and ``all_reduce``, as an H100 run showed).  A reduce-scatter
sums values, so it moves them in their own dtype (float32 gradients).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist

from ..core.mesh import collective

_state = threading.local()

LM_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "res_seq": None,   # residual stream between blocks (SP shards this one)
    "act_embed": None,
    "cache_seq": None,
    # params: FSDP over 'data' on the embed dim + Megatron TP over 'model'
    "embed": "data",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "expert_cap": None,
    "layers": None,
    "kv_lora": None,
}

# sequence parallelism: residual stream sharded over 'model' between blocks
LM_RULES_SP = dict(LM_RULES, res_seq="model")

# serving: KV cache sharded along its sequence axis over 'model'
LM_PREFILL_RULES = dict(LM_RULES, cache_seq="model")
LM_DECODE_RULES = dict(LM_RULES, cache_seq="model")
# batch=1 long-context decode: cache over 'data', single query replicated
LM_DECODE_LONG_RULES = dict(LM_RULES, batch=None, cache_seq="data")

# A variant for long decode: a 500k MHA cache is ~215 GB global (qwen1.5-4b) — 16-way
# seq sharding leaves 13.4 GB/device.  Shard BOTH cache_seq (data) and
# head_dim/kv_lora (model) for 256-way placement (~0.9 GB/device); the
# attention einsum contracts the sharded head_dim with one small psum and
# the softmax reduces over the sharded seq axis.
LM_DECODE_LONG_RULES_V2 = dict(
    LM_RULES, batch=None, cache_seq="data", heads=None, head_dim="model",
    kv_lora="model",
)

GNN_RULES = {
    "nodes": ("pod", "data"),
    "edges": ("pod", "data", "model"),
    "feat": None,
    "batch": ("pod", "data"),
    "layers": None,
    "hidden": None,
}

# A variant: tensor-parallel channels instead of 512-way
# edge sharding — edge tensors shard (pod,data), hidden dim shards 'model',
# so the per-layer node-aggregation all-reduce carries 1/16 of the bytes and
# the (E, coef, d) message tensors never cross the model axis.
GNN_RULES_TP = dict(GNN_RULES, edges=("pod", "data"), hidden="model")

RECSYS_RULES = {
    "batch": ("pod", "data"),
    "vocab_rows": "model",
    "embed": None,
    "seq": None,
    "act_embed": None,
    "heads": None,
    "ff": None,
    "candidates": "model",
    "layers": None,
}

# retrieval_cand: one query, 10⁶ candidates sharded across the whole mesh
RECSYS_RETRIEVAL_RULES = dict(
    RECSYS_RULES, batch=None, candidates=("pod", "data", "model")
)

GRAPH_ENGINE_RULES = {
    "blocks": ("pod", "data", "model"),
    "slots": None,
    "vertices": None,
}


class PartitionSpec(tuple):
    """One entry a dimension: ``None`` (replicated), a mesh axis name, or a
    tuple of them (split over their product, the first the slowest).

    The entries are kept as resolved, so ``("data",)`` and ``"data"`` stay
    distinct in the tuple; equality and hashing read a one-axis tuple as
    its axis and an empty tuple as ``None``, as ``jax.sharding.PartitionSpec``
    compares, so a spec equals ``tuple(jax_spec)`` under any JAX version."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __getnewargs__(self):  # pickle: rebuild from the entries, not from one tuple
        return tuple(self)

    def _normal(self) -> tuple:
        return tuple(_normal_entry(e) for e in self)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self._normal() == tuple(_normal_entry(e) for e in other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._normal())


def _normal_entry(entry):
    if isinstance(entry, tuple):
        if not entry:
            return None
        if len(entry) == 1:
            return entry[0]
    return entry


@contextmanager
def axis_rules(rules: dict | None, mesh=None):
    """Activate a logical→mesh rule set; with ``mesh`` (anything with
    ``axis_names``: a ``ShardMesh`` or a ``ProcessMesh``) a target axis the
    mesh lacks is dropped."""
    prev = getattr(_state, "rules", None)
    prev_axes = getattr(_state, "mesh_axes", None)
    _state.rules = rules
    _state.mesh_axes = tuple(mesh.axis_names) if mesh is not None else None
    try:
        yield
    finally:
        _state.rules = prev
        _state.mesh_axes = prev_axes


def _resolve(name):
    """The mesh axes of one logical name under the active rules: None, an
    axis name, or a tuple of the target's axes that the mesh has."""
    rules = getattr(_state, "rules", None)
    if rules is None or name is None:
        return None
    target = rules.get(name)
    mesh_axes = getattr(_state, "mesh_axes", None)
    if target is None:
        return None
    if isinstance(target, str):
        if mesh_axes is not None and target not in mesh_axes:
            return None
        return target
    kept = tuple(a for a in target if mesh_axes is None or a in mesh_axes)
    return kept if kept else None


def logical_to_spec(*names) -> PartitionSpec:
    """Map logical axis names (or None) to a ``PartitionSpec`` under the
    active rules; inactive rules give a replicated spec."""
    return PartitionSpec(*[_resolve(nm) for nm in names])


def constrain(x, *names):
    """``x`` itself.  In the JAX package this pins an intermediate's
    sharding for XLA's propagation; in eager PyTorch a tensor lives where
    the op that made it ran, and that follows from where the step put its
    inputs (the gathered parameters and the rank's rows), so there is
    nothing to pin."""
    return x


def spec_tree(logical_tree):
    """A tree of logical-name tuples (dicts and lists of them; a tuple is a
    leaf, ``()`` a 0-d tensor's) as a tree of ``PartitionSpec``s."""
    if isinstance(logical_tree, tuple):
        return logical_to_spec(*logical_tree)
    if isinstance(logical_tree, dict):
        return {k: spec_tree(v) for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [spec_tree(v) for v in logical_tree]
    return logical_tree


# ----------------------------------------------------------------------
# placement on a process mesh
# ----------------------------------------------------------------------
def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, the first the slowest."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_spec(spec, ndim: int, mesh, what: str) -> list:
    """Each dimension's axes; raises on a spec longer than the tensor's
    rank, an axis the mesh lacks, or a mesh axis used twice."""
    if len(spec) > ndim:
        raise ValueError(f"{what}: spec {spec} has {len(spec)} entries for a {ndim}-d tensor")
    dims = [spec_axes(e) for e in spec]
    used = [a for axes in dims for a in axes]
    for a in used:
        mesh.axis_size(a)  # raises on an axis the mesh lacks
    if len(set(used)) != len(used):
        raise ValueError(f"{what}: spec {spec} uses a mesh axis twice")
    return dims


def shard_block(x: torch.Tensor, spec, mesh, *, what: str = "tensor") -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (a view).
    Raises ``ValueError`` naming ``what`` if a dimension does not split
    evenly."""
    shape = block_shape(x.shape, spec, mesh, what=what)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            x = x.narrow(d, mesh.shard_index(axes) * shape[d], shape[d])
    return x


def block_shape(shape, spec, mesh, *, what: str = "tensor") -> tuple:
    """The shape of a rank's block of a global tensor of ``shape``."""
    out = list(shape)
    for d, axes in enumerate(_check_spec(spec, len(shape), mesh, what)):
        parts = math.prod(mesh.axis_size(a) for a in axes)
        if out[d] % parts:
            raise ValueError(f"{what}: dim {d} of size {out[d]} does not split evenly "
                             f"over {parts} parts (mesh axes {axes})")
        out[d] //= parts
    return tuple(out)


def _all_gather_dim(block: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim`` in rank
    order, moved as bytes."""
    raw = block.contiguous()
    flat = raw.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    return torch.cat([p.view(raw.dtype).reshape(raw.shape) for p in parts], dim=dim)


def gather_blocks(block: torch.Tensor, spec, global_shape, mesh, *,
                  what: str = "tensor") -> torch.Tensor:
    """The global tensor of ``global_shape`` from every rank's ``block``:
    one all-gather an axis of each split dimension, on that axis's group,
    the fastest axis first.  Every rank of the mesh calls it, in the same
    order as its other collectives.  A replicated block comes back as is."""
    _check_spec(spec, len(global_shape), mesh, what)
    if block_shape(global_shape, spec, mesh, what=what) != tuple(block.shape):
        raise ValueError(f"{what}: block {tuple(block.shape)} is not a block of "
                         f"{tuple(global_shape)} under {spec}")
    return gather_over(block, spec, mesh, mesh.axis_names)


def gather_over(block: torch.Tensor, spec, mesh, axes) -> torch.Tensor:
    """``block`` gathered over the mesh ``axes`` alone: the rank's block
    under ``spec`` less them (no checks; every rank of ``axes`` calls it)."""
    x = block
    for d, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):
            if a in axes and mesh.axis_size(a) > 1:
                x = _all_gather_dim(x, d, mesh.axis_groups[a], mesh.axis_size(a))
    return x


def reduce_scatter_blocks(t: torch.Tensor, spec, mesh, axes, *, keep=()) -> torch.Tensor:
    """The inverse of ``gather_over(block, spec, mesh, axes + keep)`` for a
    sum: ``t`` summed over the mesh ``axes`` into the rank's part (one
    reduce-scatter an axis, the slowest axis of a dimension first), and cut
    to the rank's part over ``keep``, whose ranks hold the same ``t`` (no
    collective).  ``t`` is summed in its own dtype."""
    for d in reversed(range(len(spec))):
        for a in spec_axes(spec[d]):
            k = mesh.axis_size(a)
            if k == 1 or (a not in axes and a not in keep):
                continue
            idx = mesh.coords[mesh.axis_names.index(a)]
            if a in keep:
                t = t.narrow(d, idx * (t.shape[d] // k), t.shape[d] // k)
                continue
            rows = t.movedim(d, 0).contiguous()
            part = rows.new_empty((rows.shape[0] // k,) + tuple(rows.shape[1:]))
            collective("reduce_scatter")(part, rows, op=dist.ReduceOp.SUM,
                                         group=mesh.axis_groups[a])
            t = part.movedim(0, d)
    return t


def spec_leaves(tree, specs) -> list:
    """``(path, leaf, spec)`` of a tree and its spec tree, in walk order
    (dicts by their keys' order, lists in order)."""
    out = []

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)) and not isinstance(spec, PartitionSpec):
            for i, (n, s) in enumerate(zip(node, spec, strict=True)):
                walk(n, s, f"{path}/{i}")
        else:
            out.append((path, node, spec))

    walk(tree, specs, "")
    return out


def _rebuild(tree, specs, leaves):
    it = iter(leaves)
    return _map_with_spec(lambda _leaf, _spec: next(it), tree, specs)


def _map_with_spec(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_with_spec(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, PartitionSpec):
        return type(tree)(_map_with_spec(fn, t, s) for t, s in zip(tree, specs, strict=True))
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """Every leaf's block (``shard_block``) under the spec tree ``specs``;
    an uneven split raises naming the leaf's path."""
    blocks = [shard_block(leaf, spec, mesh, what=path) for path, leaf, spec
              in spec_leaves(tree, specs)]
    return _rebuild(tree, specs, blocks)


def gather_tree(blocks, specs, shapes, mesh):
    """Every leaf's global tensor (``gather_blocks``), ``shapes`` a tree of
    the global shapes (anything with ``.shape``); leaves in walk order, so
    every rank issues the same collectives in the same order."""
    shape_of = {path: tuple(s.shape) for path, s, _ in spec_leaves(shapes, specs)}
    full = [gather_blocks(b, spec, shape_of[path], mesh, what=path) for path, b, spec
            in spec_leaves(blocks, specs)]
    return _rebuild(blocks, specs, full)
