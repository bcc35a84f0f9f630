"""Synthetic SASRec data: user interaction sequences with next-item
positives and sampled negatives (the paper's training regime), plus
candidate-list generation for retrieval scoring.

A ``torch.Generator`` takes the place of ``jax.random``: the draws differ
from the JAX package's, the invariants are the same (ids in range, a
zero-padded prefix shorter than ``seq_len // 2`` per row, the positives a
fixed drift of the history).
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def make_sasrec_batch_fn(vocab: int, batch: int, seq_len: int, *, device=None):
    """Returns make_batch(step) → {seq, pos, neg}, int32 (B, L) on ``device``
    (default ``cuda``), drawn from a generator seeded with ``step``
    (0 = padding item)."""
    dev = resolve_device(device)

    def make_batch(step: int) -> dict:
        g = torch.Generator(dev).manual_seed(step)
        seq = torch.randint(1, vocab, (batch, seq_len), generator=g, device=dev)
        # next-item target: a deterministic drift in item space (learnable)
        pos = (seq * 31 + 7) % (vocab - 1) + 1
        neg = torch.randint(1, vocab, (batch, seq_len), generator=g, device=dev)
        # zero-pad a random prefix per row (variable-length histories)
        cut = torch.randint(0, seq_len // 2, (batch, 1), generator=g, device=dev)
        mask = torch.arange(seq_len, device=dev)[None, :] >= cut
        return {name: torch.where(mask, t, 0).to(torch.int32)
                for name, t in (("seq", seq), ("pos", pos), ("neg", neg))}

    return make_batch


def make_candidates(generator: torch.Generator, batch: int, n_candidates: int,
                    vocab: int, *, device=None) -> torch.Tensor:
    """(batch, n_candidates) int32 item ids in [0, vocab) on ``device``
    (default ``cuda``), drawn from ``generator``, which must live there (the
    padding item 0 included, as in the JAX package)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the candidates on {dev}")
    return torch.randint(0, vocab, (batch, n_candidates), generator=generator, device=dev,
                         dtype=torch.int32)
