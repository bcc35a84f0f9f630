"""The step bodies of the port's cells, as the JAX package's
``launch/steps.py`` builds them, without its mesh and shardings:

  train_step             — loss, gradient, clipping at 1.0, AdamW (any model
                           module with a ``loss_fn``); the trainer's step
                           too, with its clip, LR scale and accumulation
  sasrec_serve_step      — full-catalog scores, then the top ``TOP_K`` (100)
  sasrec_retrieval_step  — the scores of an explicit candidate list

``value_and_grad`` is ``jax.value_and_grad`` over a parameter tree;
``assert_topk_agrees`` holds one route's top-k to another's.
"""
from __future__ import annotations

import torch

from ..models import sasrec
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm, tree_leaves, tree_map

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
