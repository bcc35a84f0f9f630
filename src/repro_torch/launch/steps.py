"""The step bodies of the port's cells, as the JAX package's
``launch/steps.py`` builds them:

  train_step             — loss, gradient, clipping at 1.0, AdamW (any model
                           module with a ``loss_fn``); the trainer's step
                           too, with its clip, LR scale and accumulation
  sharded_train_step     — the same step on a ``ProcessMesh``, one rank a
                           process, the parameters and AdamW moments stored
                           as the rank's blocks (``TrainLayout``)
  sasrec_serve_step      — full-catalog scores, then the top ``TOP_K`` (100)
  sasrec_retrieval_step  — the scores of an explicit candidate list
  build_step(cell, mesh) — ``(fn, arg_specs, in_specs, out_specs)`` of a cell

``value_and_grad`` is ``jax.value_and_grad`` over a parameter tree;
``assert_topk_agrees`` holds one route's top-k to another's.

The sharded step computes what the JAX package's jitted step computes on
the global batch:

1. every parameter leaf is all-gathered to its global value;
2. the rank takes its rows of the global batch: the leading axis splits,
   contiguous, over the mesh axes that the rules' ``"batch"`` resolves to;
3. microbatch i is rows [i B/A, (i+1) B/A) of the global batch (a rank may
   hold none of it), and its loss is its masked mean over all its rows on
   every rank: one all-reduce of the A local counts (they read the batch
   alone) comes before the forward, each rank back-props
   sum_i sum_{r,i} / (A max(C_i, 1)), and one SUM all-reduce a leaf of the
   float32 gradients and of the loss runs over the batch axes.  Where those
   axes have size 1, every rank holds the whole batch, runs the one-device
   body (``accumulated_value_and_grad``) and issues no gradient collective,
   so the step is the one-device step bit for bit;
4. the full gradient is clipped by its global norm;
5. AdamW updates the rank's block of every leaf and of its moments (the
   update is elementwise).

This slice stores shards but computes on gathered parameters: a rank's
peak memory is about the one-device step's.  Every decision before a
collective reads replicated state, so every rank issues the same
collectives in the same order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..configs.common import Cell, TensorSpec
from ..core.mesh import ProcessMesh, ShardMesh
from ..distributed.shardings import (
    PartitionSpec,
    axis_rules,
    gather_tree,
    logical_to_spec,
    shard_tree,
    spec_axes,
    spec_tree,
)
from ..models import sasrec
from ..optim import (
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    state_logical_specs,
    tree_leaves,
    tree_map,
)

TOP_K = 100  # the serve cells emit the top 100 items


def value_and_grad(loss, params):
    """``(loss(params), grads)``: the value detached, and the gradient of
    every leaf of ``params`` as a tree of the same structure, in each leaf's
    dtype (zeros for a leaf the loss does not reach).  ``params`` is not
    modified."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    value = loss(live)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return value.detach(), tree_map(lambda _: next(it), params)


def accumulated_value_and_grad(loss, params, batch: dict, accum: int = 1):
    """``(mean loss, grads)`` of ``loss(params, microbatch)`` over ``accum``
    equal slices of the leading batch axis: the gradients summed in float32
    and divided (float32 leaves); ``accum`` 1 is ``value_and_grad`` of the
    whole batch."""
    if accum == 1:
        return value_and_grad(lambda p: loss(p, batch), params)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    lsum = 0.0
    for i in range(accum):
        mb = tree_map(lambda x: x[i * (x.shape[0] // accum):(i + 1) * (x.shape[0] // accum)],
                      batch)
        lval, g = value_and_grad(lambda p: loss(p, mb), params)
        tree_map(lambda a, b: a.add_(b), acc, g)
        lsum = lsum + lval
        del g
    return lsum / accum, tree_map(lambda a: a.div_(accum), acc)  # in place: no second copy


def train_step(model, params, opt_state: dict, batch: dict, cfg,
               opt_cfg: AdamWConfig | None = None, *, max_norm: float = 1.0, lr_scale=1.0,
               accum: int = 1):
    """One step of a train cell: ``(params, opt_state, {"loss", "grad_norm"})``
    after the loss and its gradient (over ``accum`` microbatches), global-norm
    clipping at ``max_norm`` (1.0) and an AdamW update at ``lr_scale`` (1).
    ``model`` is a port model module."""
    loss, grads = accumulated_value_and_grad(lambda p, b: model.loss_fn(p, b, cfg), params,
                                             batch, accum)
    grads, gn = clip_by_global_norm(grads, max_norm)  # rebound: the unclipped leaves go
    params, opt_state = adamw_update(params, grads, opt_state, opt_cfg or AdamWConfig(),
                                     lr_scale=lr_scale)
    return params, opt_state, {"loss": loss, "grad_norm": gn}


def sasrec_serve_step(params: dict, batch: dict, cfg: sasrec.SASRecConfig) -> dict:
    """``{"values": (B, 100) float32, "indices": (B, 100) int32}``: the 100
    best items of the full catalog per user, best first (``lax.top_k``)."""
    scores = sasrec.serve_scores(params, batch, cfg)
    values, indices = torch.topk(scores, TOP_K, dim=-1, largest=True, sorted=True)
    return {"values": values, "indices": indices.to(torch.int32)}


def sasrec_retrieval_step(params: dict, batch: dict, cfg: sasrec.SASRecConfig) -> torch.Tensor:
    """(B, NC) scores of ``batch["candidates"]`` for ``batch["seq"]``."""
    return sasrec.retrieval_scores(params, batch, cfg)


def assert_topk_agrees(got: dict, want: dict, ref_scores: torch.Tensor, tol: float,
                       what: str = "top-k") -> int:
    """Holds ``got`` (a serve step's output) to ``want`` (another route's,
    on the same device): the values within ``tol``; the indices equal,
    except at a near-tie, where ``ref_scores`` (the other route's full
    scores) put ``got``'s pick within ``2 tol`` of ``want``'s value at that
    rank; no item twice in a row.  Raises AssertionError, else returns the
    count of near-tie swaps."""
    torch.testing.assert_close(got["values"], want["values"], rtol=tol, atol=tol, msg=what)
    gi = got["indices"].long()
    differ = gi != want["indices"].long()
    picked = ref_scores.gather(1, gi)
    if not bool(((picked - want["values"]).abs()[differ] <= 2 * tol).all()):
        raise AssertionError(f"{what}: an index differs away from a near-tie at "
                             f"{differ.nonzero().tolist()}")
    if any(len(set(row)) != len(row) for row in gi.tolist()):
        raise AssertionError(f"{what}: an item appears twice in a row")
    return int(differ.sum())


# ----------------------------------------------------------------------
# the sharded train step on a process mesh
# ----------------------------------------------------------------------
LATER = "ROADMAP.md, queue 1"


def param_tensor_specs(model, cfg) -> dict:
    """The global parameters as a ``TensorSpec`` tree (``param_shapes``'
    shapes; an LM's leaves in ``cfg.activation_dtype``, the rest float32)."""
    dtype = getattr(cfg, "activation_dtype", torch.float32)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return TensorSpec(tuple(node[0]), dtype)

    return walk(model.param_shapes(cfg))


def opt_tensor_specs(param_specs_tree) -> dict:
    """AdamW's state of those parameters: step int32, float32 moments."""
    f32 = lambda t: TensorSpec(t.shape, torch.float32)  # noqa: E731
    return {"step": TensorSpec((), torch.int32), "m": tree_map(f32, param_specs_tree),
            "v": tree_map(f32, param_specs_tree)}


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """Where a model's training state lives on a ``ProcessMesh``: the spec
    trees of the parameters and of AdamW's state, the global shapes, and
    the mesh axes the batch's leading axis splits over."""

    mesh: ProcessMesh
    params: dict          # PartitionSpec tree of the parameters
    opt: dict             # ... of AdamW's state
    shapes: dict          # TensorSpec tree of the global parameters
    batch_axes: tuple     # mesh axes of the batch's leading axis

    @property
    def data_parallel(self) -> int:
        """The number of distinct row ranges of a batch."""
        return math.prod(self.mesh.axis_size(a) for a in self.batch_axes)

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch of ``n`` rows."""
        if n % self.data_parallel:
            raise ValueError(f"a global batch of {n} rows does not split evenly over "
                             f"{self.data_parallel} ranks (mesh axes {self.batch_axes})")
        size = n // self.data_parallel
        lo = self.mesh.shard_index(self.batch_axes) * size
        return lo, lo + size

    def opt_shapes(self) -> dict:
        return opt_tensor_specs(self.shapes)

    def meta_state(self) -> dict:
        """``{"params", "opt"}`` as meta tensors of the global shapes and
        dtypes: the example tree a checkpoint restores into."""
        meta = lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta")  # noqa: E731
        return {"params": tree_map(meta, self.shapes), "opt": tree_map(meta, self.opt_shapes())}


def train_layout(model, cfg, mesh: ProcessMesh, rules: dict | None) -> TrainLayout:
    """The ``TrainLayout`` of ``model`` under ``rules`` on ``mesh``.  Raises
    ``NotImplementedError`` for a model without ``loss_terms`` (the GNNs,
    whose nodes and edges need a combine inside the aggregation) on a mesh
    of more than one rank."""
    if mesh.size > 1 and not hasattr(model, "loss_terms"):
        raise NotImplementedError(
            f"{model.__name__} on a process mesh of {mesh.size} ranks: its node and edge axes "
            f"need a combine inside the aggregation, a later slice ({LATER})")
    with axis_rules(rules, mesh):
        p_logical = model.param_specs(cfg)
        p_spec = spec_tree(p_logical)
        o_spec = spec_tree(state_logical_specs(p_logical))
        batch_axes = spec_axes(logical_to_spec("batch")[0])
    return TrainLayout(mesh=mesh, params=p_spec, opt=o_spec,
                       shapes=param_tensor_specs(model, cfg), batch_axes=batch_axes)


def all_reduce_sum(t: torch.Tensor, axes: tuple, mesh: ProcessMesh) -> torch.Tensor:
    """``t`` summed in place over the ranks that differ from this one in
    ``axes`` alone: one all-reduce on each axis's group."""
    for a in axes:
        if mesh.axis_size(a) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.axis_groups[a])
    return t


def reduce_gradients(grads, axes: tuple, mesh: ProcessMesh):
    """The float32 gradient tree summed over ``axes``, one all-reduce a leaf
    (in walk order)."""
    for g in tree_leaves(grads):
        all_reduce_sum(g, axes, mesh)
    return grads


def data_parallel_value_and_grad(model, params, batch: dict, cfg, layout: TrainLayout,
                                 accum: int = 1):
    """``(loss, grads)`` of the global batch's step, from this rank's rows:
    the loss and float32 gradients of sum_i S_{r,i} / (A max(C_i, 1)) over
    the pieces of this rank's rows in each microbatch, summed over the
    batch axes.  ``params`` are global."""
    mesh, axes = layout.mesh, layout.batch_axes
    n = batch[next(iter(batch))].shape[0]
    lo, hi = layout.rows(n)
    mb = n // accum
    pieces = [(max(lo, i * mb), min(hi, (i + 1) * mb)) for i in range(accum)]
    dev = tree_leaves(params)[0].device
    counts = torch.zeros(accum, dtype=torch.float32, device=dev)
    for i, (a, b) in enumerate(pieces):
        if a < b:
            counts[i] = torch.sum(model.loss_mask({k: v[a:b] for k, v in batch.items()}))
    all_reduce_sum(counts, axes, mesh)
    denom = accum * torch.clamp(counts, min=1.0)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (a, b) in enumerate(pieces):
        if a >= b:
            continue
        piece = {k: v[a:b] for k, v in batch.items()}
        lval, g = value_and_grad(lambda p: model.loss_terms(p, piece, cfg)[0] / denom[i],
                                 params)
        tree_map(lambda x, y: x.add_(y), acc, g)
        loss += lval
        del g
    reduce_gradients(acc, axes, mesh)
    all_reduce_sum(loss, axes, mesh)
    return loss, acc


def sharded_train_step(model, params, opt_state: dict, batch: dict, cfg, layout: TrainLayout,
                       opt_cfg: AdamWConfig | None = None, *, max_norm: float = 1.0,
                       lr_scale=1.0, accum: int = 1):
    """One train step on ``layout.mesh``: ``params`` and ``opt_state`` are
    this rank's blocks, ``batch`` the global batch (every rank passes the
    same); returns ``(params, opt_state, {"loss", "grad_norm"})``, blocks
    again, the metrics replicated.  See the module docstring for the
    steps."""
    mesh = layout.mesh
    full = gather_tree(params, layout.params, layout.shapes, mesh)
    if layout.data_parallel == 1:
        loss, grads = accumulated_value_and_grad(lambda p, b: model.loss_fn(p, b, cfg), full,
                                                 batch, accum)
    else:
        loss, grads = data_parallel_value_and_grad(model, full, batch, cfg, layout, accum)
    del full
    grads, gn = clip_by_global_norm(grads, max_norm)
    grads = shard_tree(grads, layout.params, mesh)
    params, opt_state = adamw_update(params, grads, opt_state, opt_cfg or AdamWConfig(),
                                     lr_scale=lr_scale)
    return params, opt_state, {"loss": loss, "grad_norm": gn}


# ----------------------------------------------------------------------
# build_step: a cell's step, its inputs and their placements
# ----------------------------------------------------------------------
def _module_for(cell: Cell):
    if cell.family == "lm":
        from ..models import transformer_lm

        return transformer_lm
    if cell.family == "recsys":
        return sasrec
    from ..models.gnn import module_of

    return module_of(cell.model_cfg)


def _tensor_specs(tree) -> dict:
    """A tree of tensors as ``TensorSpec``s."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def build_step(cell: Cell, mesh):
    """``(fn, arg_specs, in_specs, out_specs)`` of ``cell`` on ``mesh`` (a
    ``ProcessMesh``, a ``ShardMesh`` or None), as the JAX package's
    ``build_step`` returns them: ``arg_specs`` the inputs' ``TensorSpec``s,
    ``in_specs`` / ``out_specs`` ``PartitionSpec`` trees from
    ``param_specs``, ``state_logical_specs``, ``cache_specs`` and
    ``cell.batch_logical`` under ``cell.rules``.

    ``fn`` is, for the LM and SASRec train cells on a ``ProcessMesh``, the
    sharded train step (blocks in, blocks out, the global batch); anywhere
    else the one-device body.  Raises ``NotImplementedError`` for the other
    kinds, and for a GNN train cell, on a process mesh of more than one rank
    (sharded caches and catalogs, and the GNNs' combine, are later slices),
    and ``TypeError`` for a train cell on a ``ShardMesh`` of more than one
    position (training takes one shard a process)."""
    mod = _module_for(cell)
    cfg = cell.model_cfg
    on_ranks = isinstance(mesh, ProcessMesh) and mesh.size > 1
    if on_ranks and (cell.kind != "train" or cell.family == "gnn"):
        raise NotImplementedError(
            f"{cell.arch}/{cell.shape} ({cell.kind}) on a process mesh of {mesh.size} ranks: "
            f"sharded caches, catalogs and the GNN aggregation's combine are a later slice "
            f"({LATER})")
    with axis_rules(cell.rules, mesh):
        p_logical = mod.param_specs(cfg)
        p_spec = spec_tree(p_logical)
        batch_spec = spec_tree(cell.batch_logical)
    params_shape = param_tensor_specs(mod, cfg)
    rep = PartitionSpec()

    if cell.kind == "train":
        with axis_rules(cell.rules, mesh):
            o_spec = spec_tree(state_logical_specs(p_logical))
        if isinstance(mesh, ShardMesh) and mesh.size > 1:
            raise TypeError(f"a train cell on a ShardMesh of {mesh.size} positions: training "
                            "takes one shard a process (a ProcessMesh)")
        if isinstance(mesh, ProcessMesh):
            layout = train_layout(mod, cfg, mesh, cell.rules)

            def fn(params, opt_state, batch):
                return sharded_train_step(mod, params, opt_state, batch, cfg, layout)
        else:
            def fn(params, opt_state, batch):
                return train_step(mod, params, opt_state, batch, cfg)
        specs = (params_shape, opt_tensor_specs(params_shape), cell.batch_specs)
        return (fn, specs, (p_spec, o_spec, batch_spec),
                (p_spec, o_spec, {"loss": rep, "grad_norm": rep}))

    if cell.kind == "prefill":
        def fn(params, batch):
            return mod.prefill(params, batch["tokens"], cfg)

        with axis_rules(cell.rules, mesh):
            c_spec = spec_tree(mod.cache_specs(cfg))
            logits_spec = logical_to_spec("batch", "vocab")
        return (fn, (params_shape, cell.batch_specs), (p_spec, batch_spec),
                (logits_spec, c_spec))

    if cell.kind == "decode":
        B = cell.batch_specs["tokens"].shape[0]
        cache = mod.make_cache(cfg, B, cfg.kv_block, device="meta")
        with axis_rules(cell.rules, mesh):
            c_spec = spec_tree(mod.cache_specs(cfg))
            logits_spec = logical_to_spec("batch", "vocab")

        def fn(params, caches, batch):
            return mod.decode_step(params, caches, batch["tokens"], int(batch["pos"]), cfg)

        return (fn, (params_shape, _tensor_specs(cache), cell.batch_specs),
                (p_spec, c_spec, batch_spec), (logits_spec, c_spec))

    if cell.kind == "serve":
        with axis_rules(cell.rules, mesh):
            out_spec = logical_to_spec("batch", None)

        def fn(params, batch):
            return sasrec_serve_step(params, batch, cfg)

        return (fn, (params_shape, cell.batch_specs), (p_spec, batch_spec),
                {"values": out_spec, "indices": out_spec})

    if cell.kind == "retrieval":
        with axis_rules(cell.rules, mesh):
            out_spec = logical_to_spec("batch", "candidates")

        def fn(params, batch):
            return sasrec_retrieval_step(params, batch, cfg)

        return fn, (params_shape, cell.batch_specs), (p_spec, batch_spec), out_spec

    raise ValueError(cell.kind)
