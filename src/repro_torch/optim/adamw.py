"""AdamW as pure functions over the port's parameter trees, as the JAX
package's ``optim/adamw.py`` (no ``torch.optim``: its update is the
reference, term for term).

The state is ``{"step": 0-d int32, "m": tree, "v": tree}``; the moments are
float32 whatever the parameter dtype, the update is computed in float32 and
rounded once to the parameter's dtype.  Bias correction divides the moments
by ``1 - b**t``; the weight decay is decoupled (added to the step
direction, times ``lr``).  The update is elementwise, so a rank that
updates its block of every leaf gets the block of the whole update, bit
for bit; ``state_logical_specs`` gives the moments the params' placement.
"""
from __future__ import annotations

import dataclasses

import torch

from .tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def init(params) -> dict:
    """Step 0 and zero float32 moments of ``params``' shapes, on their devices."""
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
    }


def update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0):
    """``(new params, new state)`` after one AdamW step with learning rate
    ``cfg.lr * lr_scale`` (a float or a 0-d tensor).  Pure: the inputs are
    not written."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale

    m2 = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g.float(), state["m"], grads)
    v2 = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g.float() * g.float(),
                  state["v"], grads)

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    return tree_map(upd, params, m2, v2), {"step": step, "m": m2, "v": v2}


def state_logical_specs(param_logical_specs) -> dict:
    """The state's logical axes: the moments share the params' logical
    axes; ``step`` is replicated."""
    return {"step": (), "m": param_logical_specs, "v": param_logical_specs}
