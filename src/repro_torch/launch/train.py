"""Fault-tolerant training driver, as the JAX package's ``launch/train.py``.

``Trainer(model, model_cfg, train_cfg=, device=, mesh=, rules=)`` trains
any port model module exposing ``init(cfg, generator=, device=)``,
``param_shapes``, ``param_specs`` and ``loss_fn`` (``loss_terms`` and
``loss_mask`` too where the batch splits over ranks; a GNN's ``SPLIT`` and
``loss_fn(..., part=)`` where its edge lists do):

* deterministic data (``make_batch(step)``) → bit-identical restart;
* a checkpoint of ``{"params", "opt"}`` every ``ckpt_every`` steps (the
  atomic step directories of ``checkpoint/``, keep 3) and
  ``restore_latest`` on start;
* global-norm clipping, warmup-cosine LR, AdamW;
* microbatch gradient accumulation (``accum``): equal slices of the leading
  batch axis, the gradients summed in float32 and divided;
* failure injection (``fail_at_step``) for the restart tests.

The JAX trainer compiles one step with ``jax.jit``; the port runs it
eagerly.  ``mesh=None`` (or a one-position ``ShardMesh``) trains on one
device.  ``mesh=`` a ``ProcessMesh`` trains one rank a process: every rank
builds the same ``Trainer`` and calls ``fit`` with the same arguments; the
parameters and AdamW moments live as the rank's blocks under ``rules``
(``launch.steps.sharded_train_step``).  The LM computes on its blocks:
under ``LM_RULES`` a layer's leaves are gathered over ``data`` one layer
at a time and their gradients reduce-scattered back, and heads, ff and
vocab compute on their ``model`` blocks (a MoE layer's ``moe`` subtree is
gathered whole), so no rank holds a whole leaf, gradient tree or the whole
vocabulary's logits.  SASRec gathers its parameters whole each step, its
item table too.  A GNN under ``GNN_RULES`` keeps its parameters and its
node arrays whole on every rank and splits its edge lists over the
``"edges"`` axes, one combine an aggregation.  There:

* ``init_state`` draws the full init from the generator (bit for bit the
  one-device init) and keeps the rank's blocks;
* ``fit(params=, opt_state=)`` takes global trees and returns global trees
  (every rank the same, gathered after the last step), as the JAX
  trainer's arrays are global; ``shard`` and ``gather`` convert between the
  two, and ``train_step`` works on blocks;
* a checkpoint gathers every leaf on every rank in the same order, rank 0
  writes the JAX package's format, then every rank passes a barrier; on
  restore every rank reads the checkpoint on the host and keeps its block;
* every decision before a collective (``fail_at_step``, ``ckpt_every``,
  ``accum``, ``log_every``) reads replicated state, so an injected failure
  raises on every rank before any collective of that step.

A ``ShardMesh`` of more than one position raises ``TypeError``: training
takes one shard a process.

Usage::

    trainer = Trainer(sasrec, cfg, train_cfg=TrainConfig(steps=6, ckpt_every=3))
    params, opt_state, history = trainer.fit(make_batch, ckpt_dir=...)

    mesh = make_process_mesh((2, 1), ("data", "model"))   # in every rank
    trainer = Trainer(sasrec, cfg, mesh=mesh, rules=RECSYS_RULES)
    trainer = Trainer(gin, gin_cfg, mesh=mesh, rules=GNN_RULES)
    trainer = Trainer(transformer_lm, lm_cfg, mesh=mesh, rules=LM_RULES)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..checkpoint import restore_latest, save
from ..core.mesh import ProcessMesh, ShardMesh
from ..device import resolve_device
from ..distributed.shardings import gather_tree, shard_tree
from ..optim import AdamWConfig, adamw_init, tree_map, warmup_cosine
from .steps import sharded_train_step, train_layout, train_step


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field."""

    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    grad_clip: float = 1.0
    warmup: int = 20
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    accum: int = 1                   # microbatch gradient accumulation
    fail_at_step: int | None = None  # failure injection for restart tests
    log_every: int = 10


class Trainer:
    def __init__(self, model, model_cfg, *, train_cfg: TrainConfig | None = None, device=None,
                 mesh=None, rules=None):
        self.model = model
        self.model_cfg = model_cfg
        self.cfg = train_cfg or TrainConfig()
        self.layout = None
        if isinstance(mesh, ShardMesh):
            if mesh.size > 1:
                raise TypeError(f"a ShardMesh of {mesh.size} positions: training takes one "
                                "shard a process (pass a ProcessMesh)")
            mesh = None
        if isinstance(mesh, ProcessMesh):
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            self.layout = train_layout(model, model_cfg, mesh, rules)
            device = mesh.device
        elif mesh is not None:
            raise TypeError(f"mesh must be a ProcessMesh or a ShardMesh, not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.rules = rules
        self.device = resolve_device(device)

    def train_step(self, params, opt_state: dict, batch: dict):
        """One step: ``(params, opt_state, {"loss", "grad_norm", "lr_scale"})``;
        on a process mesh the state is the rank's blocks and ``batch`` the
        global batch."""
        tc = self.cfg
        lr_scale = warmup_cosine(opt_state["step"], warmup=tc.warmup, total=max(tc.steps, 2))
        if self.layout is None:
            params, opt_state, metrics = train_step(
                self.model, params, opt_state, batch, self.model_cfg, tc.adamw,
                max_norm=tc.grad_clip, lr_scale=lr_scale, accum=tc.accum)
        else:
            params, opt_state, metrics = sharded_train_step(
                self.model, params, opt_state, batch, self.model_cfg, self.layout, tc.adamw,
                max_norm=tc.grad_clip, lr_scale=lr_scale, accum=tc.accum)
        return params, opt_state, dict(metrics, lr_scale=lr_scale)

    def init_state(self, generator: torch.Generator):
        """``(params, opt_state)``: the model's ``init`` drawn from
        ``generator`` on the trainer's device, and AdamW's zero state; on a
        process mesh the rank's blocks of them."""
        params = self.model.init(self.model_cfg, generator=generator, device=self.device)
        if self.layout is not None:
            params = tree_map(torch.clone, shard_tree(params, self.layout.params,
                                                      self.layout.mesh))
        return params, adamw_init(params)

    def shard(self, params, opt_state):
        """The rank's blocks of global ``params`` and ``opt_state`` (no
        collective), on the trainer's device."""
        lay = self.layout
        to = lambda t: t.to(self.device, copy=True)  # noqa: E731
        return (tree_map(to, shard_tree(params, lay.params, lay.mesh)),
                tree_map(to, shard_tree(opt_state, lay.opt, lay.mesh)))

    def gather(self, params, opt_state):
        """Global ``params`` and ``opt_state`` from the ranks' blocks: every
        rank calls it (all-gathers, in the same order on every rank)."""
        lay = self.layout
        return (gather_tree(params, lay.params, lay.shapes, lay.mesh),
                gather_tree(opt_state, lay.opt, lay.opt_shapes(), lay.mesh))

    def _save(self, ckpt_dir: str, step: int, params, opt_state):
        if self.layout is None:
            save(ckpt_dir, step, {"params": params, "opt": opt_state})
            return
        full_p, full_o = self.gather(params, opt_state)
        if self.layout.mesh.rank == 0:
            save(ckpt_dir, step, {"params": full_p, "opt": full_o})
        dist.barrier(group=self.layout.mesh.group)

    def _restore(self, ckpt_dir: str, params, opt_state):
        """``(params, opt_state, step)`` from the newest checkpoint, or the
        given state and step 0."""
        if self.layout is None:
            restored, rstep = restore_latest(ckpt_dir, {"params": params, "opt": opt_state},
                                             device=self.device)
            if restored is None:
                return params, opt_state, 0
            return restored["params"], restored["opt"], rstep
        restored, rstep = restore_latest(ckpt_dir, self.layout.meta_state(), device="cpu")
        if restored is None:
            return params, opt_state, 0
        return (*self.shard(restored["params"], restored["opt"]), rstep)

    def fit(self, make_batch: Callable[[int], Any], *, generator: torch.Generator | None = None,
            steps: int | None = None, ckpt_dir: str | None = None, params=None,
            opt_state=None):
        """Run (or resume) the training loop; returns ``(params, opt_state,
        history)``.  ``make_batch(step)`` must be deterministic in ``step``:
        that is what makes restart bit-identical.  Without ``params`` the
        state is drawn from ``generator`` (default: seed 0 on the trainer's
        device), then replaced by the newest checkpoint of ``ckpt_dir`` if
        there is one.  ``history`` holds ``step``, ``loss``, ``grad_norm``
        and ``sec_per_step`` (host seconds of the step, ending when its
        metrics are read back) every ``log_every`` steps and at the first.
        On a process mesh ``params`` / ``opt_state`` are global trees in and
        out (see the module docstring)."""
        tc = self.cfg
        steps = steps or tc.steps
        ckpt_dir = ckpt_dir or tc.ckpt_dir
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        start = 0
        if params is None:
            params, opt_state = self.init_state(generator)
            if ckpt_dir:
                params, opt_state, start = self._restore(ckpt_dir, params, opt_state)
        elif self.layout is not None:
            params, opt_state = self.shard(params, opt_state)
        history = []
        for step in range(start, steps):
            if tc.fail_at_step is not None and step == tc.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = make_batch(step)
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            if ckpt_dir and (step + 1) % tc.ckpt_every == 0:
                self._save(ckpt_dir, step + 1, params, opt_state)
            if (step + 1) % tc.log_every == 0 or step == start:
                loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
                history.append({"step": step + 1, "loss": loss, "grad_norm": gn,
                                "sec_per_step": time.perf_counter() - t0})
        if self.layout is not None:
            params, opt_state = self.gather(params, opt_state)
        return params, opt_state, history
