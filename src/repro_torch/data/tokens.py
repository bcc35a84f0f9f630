"""Deterministic synthetic LM data, as the JAX package's ``data/tokens.py``.

``make_batch(step)`` is a pure function of the step index, the property the
fault-tolerant trainer relies on for bit-identical restarts (the data
cursor is just the step in the checkpoint).  A ``torch.Generator`` seeded
with the step takes the place of ``jax.random.PRNGKey(step)``: the draws
differ from the JAX package's, the rule is the same.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def make_lm_batch_fn(vocab: int, batch: int, seq: int, *, structured: bool = True,
                     device=None):
    """Returns make_batch(step) → ``{"tokens", "targets"}``, (batch, seq)
    int32 on ``device`` (default ``cuda``).  ``structured=True`` makes the
    targets a learnable function of the input (an affine map mod vocab), so
    smoke-training losses visibly decrease; else the next token (a roll)."""
    dev = resolve_device(device)

    def make_batch(step: int) -> dict:
        g = torch.Generator(dev).manual_seed(step)
        toks = torch.randint(0, vocab, (batch, seq), generator=g, device=dev,
                             dtype=torch.int32)
        if structured:
            targets = (toks.long() * 7 + 3) % vocab
        else:
            targets = torch.roll(toks, -1, dims=1)
        return {"tokens": toks, "targets": targets.to(torch.int32)}

    return make_batch
