"""Fault-tolerant training driver, as the JAX package's ``launch/train.py``,
on one device.

``Trainer(model, model_cfg, train_cfg=, device=)`` trains any port model
module exposing ``init(cfg, generator=, device=)`` and ``loss_fn``:

* deterministic data (``make_batch(step)``) → bit-identical restart;
* a checkpoint of ``{"params", "opt"}`` every ``ckpt_every`` steps (the
  atomic step directories of ``checkpoint/``, keep 3) and
  ``restore_latest`` on start;
* global-norm clipping, warmup-cosine LR, AdamW;
* microbatch gradient accumulation (``accum``): equal slices of the leading
  batch axis, the gradients summed in float32 and divided;
* failure injection (``fail_at_step``) for the restart tests.

The JAX trainer compiles one step with ``jax.jit``; the port runs it
eagerly.  Not here: ``mesh=`` / ``rules=`` (sharded training) and the
int8-compressed gradient all-reduce, which wait for the sharded cells and
the ``torch.distributed`` combine (``ROADMAP.md``, queue 1).

Usage::

    trainer = Trainer(sasrec, cfg, train_cfg=TrainConfig(steps=6, ckpt_every=3))
    params, opt_state, history = trainer.fit(make_batch, ckpt_dir=...)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..checkpoint import restore_latest, save
from ..device import resolve_device
from ..optim import AdamWConfig, adamw_init, warmup_cosine
from .steps import train_step


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
        if mesh is not None or rules is not None:
            raise NotImplementedError("sharded training (mesh=, rules=) waits for the sharded "
                                      "cells: see ROADMAP.md, queue 1")
        self.model = model
        self.model_cfg = model_cfg
        self.cfg = train_cfg or TrainConfig()
        self.device = resolve_device(device)

    def train_step(self, params, opt_state: dict, batch: dict):
        """One step: ``(params, opt_state, {"loss", "grad_norm", "lr_scale"})``."""
        tc = self.cfg
        lr_scale = warmup_cosine(opt_state["step"], warmup=tc.warmup, total=max(tc.steps, 2))
        params, opt_state, metrics = train_step(
            self.model, params, opt_state, batch, self.model_cfg, tc.adamw,
            max_norm=tc.grad_clip, lr_scale=lr_scale, accum=tc.accum)
        return params, opt_state, dict(metrics, lr_scale=lr_scale)

    def init_state(self, generator: torch.Generator):
        """``(params, opt_state)``: the model's ``init`` drawn from
        ``generator`` on the trainer's device, and AdamW's zero state."""
        params = self.model.init(self.model_cfg, generator=generator, device=self.device)
        return params, adamw_init(params)

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
        metrics are read back) every ``log_every`` steps and at the first."""
        tc = self.cfg
        steps = steps or tc.steps
        ckpt_dir = ckpt_dir or tc.ckpt_dir
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        start = 0
        if params is None:
            params, opt_state = self.init_state(generator)
            if ckpt_dir:
                restored, rstep = restore_latest(ckpt_dir, {"params": params, "opt": opt_state},
                                                 device=self.device)
                if restored is not None:
                    params, opt_state = restored["params"], restored["opt"]
                    start = rstep
        history = []
        for step in range(start, steps):
            if tc.fail_at_step is not None and step == tc.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = make_batch(step)
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            if ckpt_dir and (step + 1) % tc.ckpt_every == 0:
                save(ckpt_dir, step + 1, {"params": params, "opt": opt_state})
            if (step + 1) % tc.log_every == 0 or step == start:
                loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
                history.append({"step": step + 1, "loss": loss, "grad_norm": gn,
                                "sec_per_step": time.perf_counter() - t0})
        return params, opt_state, history
