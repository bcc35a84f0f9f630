"""The step bodies of the port's cells, as the JAX package's
``launch/steps.py`` builds them:

  train_step             — loss, gradient, clipping at 1.0, AdamW (any model
                           module with a ``loss_fn``); the trainer's step
                           too, with its clip, LR scale and accumulation
  sharded_train_step     — the same step on a ``ProcessMesh``, one rank a
                           process, the parameters and AdamW moments stored
                           as the rank's blocks (``TrainLayout``); the LM
                           computing on its blocks
                           (``sharded_lm_value_and_grad``); a GNN's edge
                           lists split over the ranks
  sasrec_serve_step      — full-catalog scores, then the top ``TOP_K`` (100)
  sasrec_retrieval_step  — the scores of an explicit candidate list
  sharded_prefill_step / sharded_decode_step / sharded_serve_step /
  sharded_retrieval_step — the serving cells on a ``ProcessMesh``
                           (``ServeLayout``: the rank's cache range, catalog
                           block, batch rows and vocab columns)
  build_step(cell, mesh) — ``(fn, arg_specs, in_specs, out_specs)`` of a cell

``value_and_grad`` is ``jax.value_and_grad`` over a parameter tree;
``assert_topk_agrees`` holds one route's top-k to another's.

The sharded step computes what the JAX package's jitted step computes on
the global batch.  The LM (``TrainLayout.tp_axes`` set) computes on its
blocks, as XLA partitions the JAX step under ``LM_RULES``
(``sharded_lm_value_and_grad``): no leaf is gathered whole.  The embedding
and final norm are gathered over the batch axes once a step, each layer's
leaves over them one layer at a time inside its checkpointed halves (a MoE
layer's ``moe`` subtree over every axis), and their float32 gradients are
reduce-scattered back into the blocks, and all-reduced over a batch axis
that does not split them (``distributed.fsdp``); heads, ff
and vocab compute on their ``model`` blocks (``distributed.tensor_parallel``:
the logits are the rank's vocabulary columns); the leaves replicated over
the batch axes are summed by one all-reduce; the norm is summed on the
blocks (``clip_by_global_norm(mesh=)``) and AdamW updates them.  Rows,
microbatches and counts are as below, but every rank runs every
microbatch, its piece empty or not.  SASRec and the GNNs:

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

A GNN (a model module with ``SPLIT``) splits its edge lists instead of its
batch (``edge_parallel_value_and_grad``): the R ranks over the rules'
``"edges"`` axes each take an equal contiguous range of the list named by
``SPLIT`` (DimeNet's triplets), hold the node arrays whole and run the
node layers on all n rows; each aggregation combines over those axes
(``distributed.gnn``).  Each rank back-props its loss / R and one SUM
all-reduce a leaf of the float32 gradients and of the loss runs over the
edge axes: the replicated node part adds R copies of 1/R of its gradient,
each rank's edge part its own share.  Every rank then holds the same
gradient bytes, so clipping and AdamW keep the parameters replicated, bit
for bit.  Over edge axes of size 1 the rank runs the one-device body.

The sharded serving steps hold the serving state as the cell's rules
place it and compute on parameters gathered once, when the server loads
(``ServeLayout.load``; SASRec's ``item_emb`` stays the rank's block):

* prefill (``LM_PREFILL_RULES``): the rank prefills its batch rows whole
  and keeps its ``cache_seq`` block of every cache leaf;
* decode (``LM_DECODE_RULES``, ``LM_DECODE_LONG_RULES``): the owner of
  position ``pos`` writes the new row; every rank attends over its slice
  (kernel 6 with its log-sum-exp, or MLA's plain partial) and the partials
  merge over the ``cache_seq`` axes (``distributed.serving.merge_attention``,
  one all-gather a layer); the logits are the rank's vocab columns;
* serve (``RECSYS_RULES``): the rank's users' history through
  ``sharded_rows`` (kernel 5, one all-reduce), scores against its catalog
  block, a local top 100 and ``merge_topk`` over the table's axes;
* retrieval (``RECSYS_RETRIEVAL_RULES``): the candidate ids all-gathered
  over the table's axes, the candidates the rank owns scored (0 for the
  rest), one SUM all-reduce (gloo has no reduce-scatter: an all-reduce and
  the rank's slice) and the rank's block kept.

Serving computes on parameters gathered whole at load: a rank's products
use whole parameters, and its peak memory is about the one-device step's
less the serving state it does not hold.  Every decision before a
collective reads replicated state (the step's ``pos``, the shapes), so
every rank issues the same collectives in the same order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.common import Cell, TensorSpec
from ..core.mesh import ProcessMesh, ShardMesh
from ..distributed.fsdp import gather_rows, gathered, held, step_gather, step_scatter
from ..distributed.gnn import edge_slice
from ..distributed.serving import (
    all_reduce_sum,
    gather_parts,
    local_rows,
    merge_attention,
    merge_topk,
    seq_block,
    sharded_rows,
)
from ..distributed.shardings import (
    PartitionSpec,
    axis_rules,
    gather_tree,
    logical_to_spec,
    shard_tree,
    spec_axes,
    spec_leaves,
    spec_tree,
)
from ..distributed.tensor_parallel import (
    copy_to,
    reduce_from,
    vocab_cross_entropy,
    vocab_lookup,
)
from ..models import sasrec
from ..models import transformer_lm as lm
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
    trees of the parameters and of AdamW's state, the global shapes, the
    mesh axes the batch's leading axis splits over, and a GNN's edge axes
    (the mesh axes its edge lists split over; None for a model whose batch
    splits by rows), and the LM's tensor-parallel axes (None for another
    model: it computes on gathered parameters)."""

    mesh: ProcessMesh
    params: dict          # PartitionSpec tree of the parameters
    opt: dict             # ... of AdamW's state
    shapes: dict          # TensorSpec tree of the global parameters
    batch_axes: tuple     # mesh axes of the batch's leading axis
    edge_axes: tuple | None = None   # a GNN's: the rules' "edges" axes
    tp_axes: tuple | None = None     # the LM's: the axes of "heads", "ff" and "vocab"

    @property
    def edge_parallel(self) -> int:
        """The number of ranges a GNN's edge list splits into (0: no GNN)."""
        if self.edge_axes is None:
            return 0
        return math.prod(self.mesh.axis_size(a) for a in self.edge_axes)

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
    """The ``TrainLayout`` of ``model`` under ``rules`` on ``mesh``: a GNN
    (a module with ``SPLIT``) gets the axes of ``"edges"``.  Raises
    ``TypeError`` on a mesh of more than one rank for a model that splits
    neither its batch's rows (``loss_terms``) nor its edges."""
    gnn = hasattr(model, "SPLIT")
    if mesh.size > 1 and not (gnn or hasattr(model, "loss_terms")):
        raise TypeError(f"{model.__name__} on a process mesh of {mesh.size} ranks: it splits "
                        "neither its batch's rows (loss_terms) nor its edge lists (SPLIT)")
    with axis_rules(rules, mesh):
        p_logical = model.param_specs(cfg)
        p_spec = spec_tree(p_logical)
        o_spec = spec_tree(state_logical_specs(p_logical))
        batch_axes = spec_axes(logical_to_spec("batch")[0])
        edge_axes = spec_axes(logical_to_spec("edges")[0]) if gnn else None
        tp = {n: spec_axes(logical_to_spec(n)[0]) for n in ("heads", "ff", "vocab")}
    tp_axes = None
    if model is lm:
        if len(set(tp.values())) != 1:
            raise ValueError(f"heads, ff and vocab split over different mesh axes {tp}: the "
                             "LM's tensor parallelism takes one set")
        tp_axes = tp["heads"]
        _check_heads(cfg, mesh, tp_axes)
    return TrainLayout(mesh=mesh, params=p_spec, opt=o_spec,
                       shapes=param_tensor_specs(model, cfg), batch_axes=batch_axes,
                       edge_axes=edge_axes, tp_axes=tp_axes)


def _check_heads(cfg, mesh: ProcessMesh, axes: tuple) -> None:
    """Contiguous column blocks of ``heads`` keep each query group with its
    kv head only when both head counts split evenly: raises ``ValueError``
    naming the leaf otherwise."""
    parts = math.prod(mesh.axis_size(a) for a in axes)
    key = lm._stacks(cfg)[0][0]
    counts = [("wq", cfg.n_heads)] + ([] if cfg.attn == "mla" else [("wk", cfg.n_kv_heads)])
    for leaf, n in counts:
        if n % parts:
            raise ValueError(f"/{key}/attn/{leaf}: {n} heads do not split evenly over {parts} "
                             f"parts (mesh axes {axes})")


def reduce_gradients(grads, axes: tuple, mesh: ProcessMesh):
    """The float32 gradient tree summed over ``axes``, one all-reduce a leaf
    (in walk order)."""
    for g in tree_leaves(grads):
        all_reduce_sum(g, mesh, axes)
    return grads


def _axes_of(spec) -> tuple:
    """The mesh axes ``spec`` splits over."""
    return tuple(a for e in spec for a in spec_axes(e))


def _split_axes(tree, specs) -> list:
    """The mesh axes each leaf of ``tree`` is split over, in walk order."""
    return [_axes_of(spec) for _, _, spec in spec_leaves(tree, specs)]


_HELD = ("embed", "final_norm")   # the LM's leaves gathered once a step


def sharded_lm_value_and_grad(blocks, batch: dict, cfg, layout: TrainLayout, accum: int = 1):
    """``(loss, grads)`` of the LM's step on the global batch from this
    rank's blocks and rows, computed on the blocks (``models.transformer_lm``
    ``TrainShard``): the float32 gradients come back as the rank's blocks.

    Rows and microbatches as ``data_parallel_value_and_grad`` takes them,
    except that every rank runs every microbatch's forward and backward,
    an empty piece too: the collectives sit inside them.  The tied
    embedding and the final norm are gathered over the batch axes once a
    step and their gradients summed into the blocks once; each layer's
    leaves are gathered inside its checkpointed halves and their gradients
    summed in the backward, a microbatch at a time (``distributed.fsdp``:
    a reduce-scatter over the batch axes a leaf splits, an all-reduce over
    the others, ``pod`` under ``LM_RULES``).  Leaves that no batch axis
    splits (the qkv biases, ``kv_norm``; every leaf where ``data`` has one
    rank) are summed by one all-reduce over the batch axes."""
    mesh, axes, tp = layout.mesh, layout.batch_axes, layout.tp_axes
    dev = tree_leaves(blocks)[0].device
    pieces, denom, mb = _microbatches(lm, batch, layout, accum, dev)
    size = batch[next(iter(batch))].shape[0] // layout.data_parallel   # rows a rank
    specs = layout.params
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), blocks)
    anchor = torch.zeros((), device=dev, requires_grad=True)
    full = {k: step_gather(blocks[k], specs[k], mesh, axes) for k in _HELD}
    sinks = {k: torch.zeros(full[k].shape, dtype=torch.float32, device=dev) for k in _HELD}
    vocab = seq_block(mesh, tp, cfg.vocab)

    def gather(block, spec, sink, whole):
        if isinstance(block, dict):
            return {k: gather(block[k], spec[k], sink[k], whole) for k in block}
        inner = PartitionSpec(*spec[1:])          # the leading "layers" axis is not split
        keep = tuple(a for a in _axes_of(inner) if a not in axes) if whole else ()
        return gathered(anchor, block, sink, inner, mesh, axes, keep)

    def layer(key, i, names, whole=()):
        return {nm: gather(_at(blocks[key][nm], i), specs[key][nm], _at(acc[key][nm], i),
                           nm in whole)
                for nm in tuple(names) + tuple(whole)}

    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (a, b) in enumerate(pieces):
        sizes = [max(0, min(r * size + size, (i + 1) * mb) - max(r * size, i * mb))
                 for r in range(layout.data_parallel)]
        at = a - i * mb                           # the piece's first row in the microbatch
        shard = lm.TrainShard(
            layer=layer, enter=lambda x: copy_to(x, mesh, tp),
            leave=lambda x: reduce_from(x, mesh, tp),
            lookup=lambda rows, ids: vocab_lookup(rows, ids, vocab[0], mesh, tp),
            xent=lambda logits, t: vocab_cross_entropy(logits, t, vocab[0], mesh, tp),
            tokens=lambda h, sizes=sizes: gather_rows(h, sizes, mesh, axes),
            rows=(at, at + max(b - a, 0)))
        params = dict(blocks, **{k: held(anchor, full[k], sinks[k]) for k in _HELD})
        piece = {k: v[a:max(a, b)] for k, v in batch.items()}
        part = lm.loss_terms(params, piece, cfg, shard=shard)[0] / denom[i]
        part.backward()
        loss += part.detach()
    del full
    for k in _HELD:
        acc[k].add_(step_scatter(sinks[k], specs[k], mesh, axes))
    replicated = [g for g, split in zip(tree_leaves(acc), _split_axes(acc, specs))
                  if not any(a in split and mesh.axis_size(a) > 1 for a in axes)]
    if replicated and layout.data_parallel > 1:
        flat = torch.cat([g.reshape(-1) for g in replicated])
        reduce_gradients([flat], axes, mesh)
        for g, f in zip(replicated, flat.split([g.numel() for g in replicated])):
            g.copy_(f.view_as(g))
    all_reduce_sum(loss, mesh, axes)
    return loss, acc


def _at(tree, i: int):
    """Layer ``i`` of a stacked leaf or tree: views."""
    return {k: _at(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def _microbatches(model, batch: dict, layout: TrainLayout, accum: int, dev):
    """``(pieces, denom, mb)``: this rank's rows [a, b) of each of the
    ``accum`` microbatches of ``mb`` rows (empty where a >= b), and each
    microbatch's denominator A max(C_i, 1), C_i its unmasked positions over
    every rank (one all-reduce of the A counts over the batch axes)."""
    n = batch[next(iter(batch))].shape[0]
    lo, hi = layout.rows(n)
    mb = n // accum
    pieces = [(max(lo, i * mb), min(hi, (i + 1) * mb)) for i in range(accum)]
    counts = torch.zeros(accum, dtype=torch.float32, device=dev)
    for i, (a, b) in enumerate(pieces):
        if a < b:
            counts[i] = torch.sum(model.loss_mask({k: v[a:b] for k, v in batch.items()}))
    all_reduce_sum(counts, layout.mesh, layout.batch_axes)
    return pieces, accum * torch.clamp(counts, min=1.0), mb


def data_parallel_value_and_grad(model, params, batch: dict, cfg, layout: TrainLayout,
                                 accum: int = 1):
    """``(loss, grads)`` of the global batch's step, from this rank's rows:
    the loss and float32 gradients of sum_i S_{r,i} / (A max(C_i, 1)) over
    the pieces of this rank's rows in each microbatch, summed over the
    batch axes.  ``params`` are global."""
    mesh, axes = layout.mesh, layout.batch_axes
    dev = tree_leaves(params)[0].device
    pieces, denom, _ = _microbatches(model, batch, layout, accum, dev)
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
    all_reduce_sum(loss, mesh, axes)
    return loss, acc


def edge_parallel_value_and_grad(model, params, batch: dict, cfg, layout: TrainLayout):
    """``(loss, grads)`` of a GNN's step on the global batch (whole on every
    rank), from this rank's range of the list ``model.SPLIT`` names: the
    loss / R and its float32 gradients with every aggregation combined over
    the edge axes (``distributed.gnn.edge_slice``), then summed over those
    axes.  ``params`` are global."""
    mesh, axes = layout.mesh, layout.edge_axes
    part = edge_slice(mesh, axes, batch[model.SPLIT].shape[0])
    loss, grads = value_and_grad(lambda p: model.loss_fn(p, batch, cfg, part=part) / part.parts,
                                 params)
    reduce_gradients(grads, axes, mesh)
    all_reduce_sum(loss, mesh, axes)
    return loss, grads


def sharded_train_step(model, params, opt_state: dict, batch: dict, cfg, layout: TrainLayout,
                       opt_cfg: AdamWConfig | None = None, *, max_norm: float = 1.0,
                       lr_scale=1.0, accum: int = 1):
    """One train step on ``layout.mesh``: ``params`` and ``opt_state`` are
    this rank's blocks, ``batch`` the global batch (every rank passes the
    same); returns ``(params, opt_state, {"loss", "grad_norm"})``, blocks
    again, the metrics replicated.  See the module docstring for the
    steps.  A GNN's edge split takes no ``accum`` but 1: a graph batch
    does not cut into microbatches by its leading axis."""
    mesh = layout.mesh
    if layout.edge_parallel > 1 and accum != 1:
        raise ValueError(f"accum {accum} with a GNN's edges split over {layout.edge_parallel} "
                         "ranks: a graph batch does not cut into microbatches")
    if layout.tp_axes is not None:
        loss, grads = sharded_lm_value_and_grad(params, batch, cfg, layout, accum)
        grads, gn = clip_by_global_norm(grads, max_norm, mesh,
                                      _split_axes(grads, layout.params))
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg or AdamWConfig(),
                                         lr_scale=lr_scale)
        return params, opt_state, {"loss": loss, "grad_norm": gn}
    full = gather_tree(params, layout.params, layout.shapes, mesh)
    if layout.edge_parallel > 1:
        loss, grads = edge_parallel_value_and_grad(model, full, batch, cfg, layout)
    elif layout.data_parallel == 1 or layout.edge_axes is not None:
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
# the sharded serving steps on a process mesh
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """Where a serving cell's state lives on a ``ProcessMesh``: the spec
    tree and global shapes of the parameters, the top-level leaves that stay
    the rank's block when the server loads (SASRec's ``item_emb``), and the
    mesh axes that split the batch's rows, a cache's ``cache_seq``, the
    logits' vocab columns, the item table's rows and a candidate list."""

    mesh: ProcessMesh
    params: dict          # PartitionSpec tree of the parameters
    shapes: dict          # TensorSpec tree of the global parameters
    kept: tuple           # leaves kept as the rank's block at load
    batch_axes: tuple
    seq_axes: tuple
    vocab_axes: tuple
    rows_axes: tuple
    cand_axes: tuple

    def block(self, axes: tuple, n: int) -> tuple[int, int]:
        """This rank's range [lo, hi) of a dimension of ``n`` over ``axes``."""
        return seq_block(self.mesh, axes, n)

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch of ``n`` rows."""
        return self.block(self.batch_axes, n)

    def load(self, blocks: dict) -> dict:
        """The serving parameters from the rank's blocks: every leaf
        gathered (``gather_tree``, once, when the server loads) except the
        ``kept`` ones, which stay blocks."""
        rest = lambda t: {k: v for k, v in t.items() if k not in self.kept}  # noqa: E731
        full = gather_tree(rest(blocks), rest(self.params), rest(self.shapes), self.mesh)
        return {k: blocks[k] if k in self.kept else full[k] for k in blocks}

    def cache_slice(self, max_seq: int):
        """The ``transformer_lm.CacheSlice`` of a cache of ``max_seq``
        positions: this rank's range and the merge over ``seq_axes``."""
        lo, hi = self.block(self.seq_axes, max_seq)
        return lm.CacheSlice(lo, hi, max_seq,
                             lambda out, lse: merge_attention(out, lse, self.mesh,
                                                              self.seq_axes))


def serve_layout(model, cfg, mesh: ProcessMesh, rules: dict | None) -> ServeLayout:
    """The ``ServeLayout`` of ``model`` (the LM or SASRec) under ``rules``
    on ``mesh``."""
    with axis_rules(rules, mesh):
        p_spec = spec_tree(model.param_specs(cfg))
        axes = {name: spec_axes(logical_to_spec(name)[0])
                for name in ("batch", "cache_seq", "vocab", "vocab_rows", "candidates")}
    return ServeLayout(mesh=mesh, params=p_spec, shapes=param_tensor_specs(model, cfg),
                       kept=("item_emb",) if model is sasrec else (),
                       batch_axes=axes["batch"], seq_axes=axes["cache_seq"],
                       vocab_axes=axes["vocab"], rows_axes=axes["vocab_rows"],
                       cand_axes=axes["candidates"])


def sharded_prefill_step(params: dict, tokens: torch.Tensor, cfg, layout: ServeLayout,
                         max_seq: int | None = None):
    """Prefill on ``layout.mesh``: ``params`` gathered (``ServeLayout.load``),
    ``tokens`` this rank's batch rows (B_r, S), prefilled whole into caches
    of ``max_seq`` positions (default S) of which the rank keeps its
    ``cache_seq`` block.  Returns ``(logits (B_r, V_r), caches)``: the last
    position's logits at the rank's vocab columns and its cache blocks."""
    part = layout.cache_slice(max_seq or tokens.shape[1])
    vocab = layout.block(layout.vocab_axes, cfg.vocab)
    return lm.prefill(params, tokens, cfg, cache_slice=part, vocab=vocab)


def sharded_decode_step(params: dict, caches: dict, tokens: torch.Tensor, pos: int, cfg,
                        layout: ServeLayout, *, attention=None):
    """One decode step on ``layout.mesh``: ``caches`` the rank's blocks (its
    batch rows, its ``cache_seq`` range), ``tokens`` (B_r, 1) its rows at
    the replicated position ``pos``; ``attention`` as ``decode_step`` takes
    it.  Returns ``(logits (B_r, V_r), caches)``, the blocks updated in
    place (only the owner of ``pos`` writes)."""
    rows = next(iter(next(iter(caches.values())).values())).shape[2]
    parts = math.prod(layout.mesh.axis_size(a) for a in layout.seq_axes)
    vocab = layout.block(layout.vocab_axes, cfg.vocab)
    return lm.decode_step(params, caches, tokens, pos, cfg, attention=attention,
                          cache_slice=layout.cache_slice(rows * parts), vocab=vocab)


def _table(params: dict, layout: ServeLayout):
    """(block, lo, lookup): this rank's ``item_emb`` rows, where they start,
    and ``sharded_rows`` over the table's axes."""
    block = params["item_emb"]
    lo = layout.block(layout.rows_axes, block.shape[0] * math.prod(
        layout.mesh.axis_size(a) for a in layout.rows_axes))[0]
    return block, lo, lambda ids: sharded_rows(block, ids, lo, layout.mesh, layout.rows_axes)


def sharded_serve_step(params: dict, batch: dict, cfg: sasrec.SASRecConfig,
                       layout: ServeLayout) -> dict:
    """``sasrec_serve_step`` on ``layout.mesh``: ``params`` loaded (the
    rank's ``item_emb`` rows, the rest whole), ``batch["seq"]`` this rank's
    users.  Their top ``TOP_K`` of the whole catalog, best first:
    ``{"values", "indices" int32}`` (B_r, 100)."""
    block, lo, lookup = _table(params, layout)
    scores = sasrec.serve_scores(params, batch, cfg, lookup=lookup)
    values, at = torch.topk(scores, min(TOP_K, block.shape[0]), dim=-1, largest=True,
                            sorted=True)
    values, indices = merge_topk(values, (at + lo).to(torch.int32), TOP_K, layout.mesh,
                                 layout.rows_axes)
    return {"values": values, "indices": indices}


def sharded_retrieval_step(params: dict, batch: dict, cfg: sasrec.SASRecConfig,
                           layout: ServeLayout) -> torch.Tensor:
    """``sasrec_retrieval_step`` on ``layout.mesh``: ``batch["seq"]`` this
    rank's users, ``batch["candidates"]`` (B_r, NC_r) its block of their
    candidate list.  The ids are all-gathered over the table's axes; the
    rank scores those whose rows it owns (0 for the rest), one SUM
    all-reduce over those axes completes every score, and the rank keeps
    its block: (B_r, NC_r)."""
    block, lo, lookup = _table(params, layout)
    mesh, axes = layout.mesh, layout.rows_axes
    cands = batch["candidates"]
    line = gather_parts(cands, mesh, axes)                  # (R, B_r, NC_r)
    ids = line.permute(1, 0, 2).reshape(cands.shape[0], -1)
    n_global = block.shape[0] * line.shape[0]
    scores = sasrec.retrieval_scores(
        params, {"seq": batch["seq"], "candidates": ids}, cfg, lookup=lookup,
        candidate_rows=lambda c: local_rows(block, c, lo, n_global))
    all_reduce_sum(scores, mesh, axes)
    r, nc = mesh.shard_index(axes), cands.shape[1]
    return scores[:, r * nc:(r + 1) * nc].contiguous()


# ----------------------------------------------------------------------
# build_step: a cell's step, its inputs and their placements
# ----------------------------------------------------------------------
def _module_for(cell: Cell):
    if cell.family == "lm":
        return lm
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

    ``fn`` is, for every cell on a ``ProcessMesh`` of more than one rank,
    the sharded step: blocks in (the parameters, a decode's caches), blocks
    out (the parameters and AdamW state, the caches, the outputs as
    ``out_specs`` place them), the global batch on every rank.  A GNN train
    cell's step keeps its node arrays whole on every rank and splits its
    edge lists (DimeNet's triplets) over the ``"edges"`` axes, whatever
    ``in_specs`` say of the nodes (``edge_parallel_value_and_grad``); its
    parameters are whole under ``GNN_RULES``.  An LM train cell's step
    computes on its blocks (``sharded_lm_value_and_grad``: FSDP over the
    batch axes one layer at a time, heads, ff and vocab over ``model``, a
    MoE layer's ``moe`` subtree gathered whole); SASRec's gathers every leaf
    whole, its item table too.  The serving steps gather the
    parameters on every call; a server gathers them once, when it loads
    (``ServeLayout.load``), and calls the ``sharded_*_step`` below it, as
    ``Trainer`` calls ``sharded_train_step``.  Anywhere else ``fn`` is the
    one-device body.  Raises ``TypeError`` for a train cell on a
    ``ShardMesh`` of more than one position (training takes one shard a
    process)."""
    mod = _module_for(cell)
    cfg = cell.model_cfg
    on_ranks = isinstance(mesh, ProcessMesh) and mesh.size > 1
    layout = serve_layout(mod, cfg, mesh, cell.rules) if on_ranks and cell.kind != "train" \
        else None
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
            if layout is None:
                return mod.prefill(params, batch["tokens"], cfg)
            lo, hi = layout.rows(batch["tokens"].shape[0])
            return sharded_prefill_step(layout.load(params), batch["tokens"][lo:hi], cfg, layout)

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
            if layout is None:
                return mod.decode_step(params, caches, batch["tokens"], int(batch["pos"]), cfg)
            lo, hi = layout.rows(batch["tokens"].shape[0])
            return sharded_decode_step(layout.load(params), caches, batch["tokens"][lo:hi],
                                       int(batch["pos"]), cfg, layout)

        return (fn, (params_shape, _tensor_specs(cache), cell.batch_specs),
                (p_spec, c_spec, batch_spec), (logits_spec, c_spec))

    if cell.kind == "serve":
        with axis_rules(cell.rules, mesh):
            out_spec = logical_to_spec("batch", None)

        def fn(params, batch):
            if layout is None:
                return sasrec_serve_step(params, batch, cfg)
            lo, hi = layout.rows(batch["seq"].shape[0])
            return sharded_serve_step(layout.load(params), {"seq": batch["seq"][lo:hi]}, cfg,
                                      layout)

        return (fn, (params_shape, cell.batch_specs), (p_spec, batch_spec),
                {"values": out_spec, "indices": out_spec})

    if cell.kind == "retrieval":
        with axis_rules(cell.rules, mesh):
            out_spec = logical_to_spec("batch", "candidates")

        def fn(params, batch):
            if layout is None:
                return sasrec_retrieval_step(params, batch, cfg)
            lo, hi = layout.rows(batch["seq"].shape[0])
            c_lo, c_hi = layout.block(layout.cand_axes, batch["candidates"].shape[1])
            return sharded_retrieval_step(
                layout.load(params), {"seq": batch["seq"][lo:hi],
                                      "candidates": batch["candidates"][lo:hi, c_lo:c_hi]},
                cfg, layout)

        return fn, (params_shape, cell.batch_specs), (p_spec, batch_spec), out_spec

    raise ValueError(cell.kind)
