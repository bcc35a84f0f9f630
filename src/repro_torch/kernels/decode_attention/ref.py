"""Plain PyTorch version of the single-token decode attention kernel.

``decode_attention_ref`` computes what the JAX package's oracle computes,
with the q heads grouped over the KV heads by a reshape: K/V are never
repeated (at a 32k cache, repeating them 6x would be gigabytes of
temporaries a layer).  The CPU route runs it, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# How far a decode attention output may lie from this plain version on the
# same inputs: ``decode_attention_rel_err``, the relative L2 difference of
# each (sequence, q head) row.  Both sum in float32 and differ only in the
# order, ~1e-7 relative at the sweep's lengths: float32 is held within
# 1e-5.  A bfloat16 output is that float32 value rounded once, so two
# versions differ by at most one ulp an element, at most 2^-7 of the
# element: 2^-7 bounds the row's relative L2 difference.  Unlike a max abs
# difference, the limit scales with the row, whose norm falls as
# 1/sqrt(rows) for random inputs (about 0.1 at 32k rows, D=128).
ATTN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def decode_attention_ref(q, k, v, pos):
    """q (B, Hq, D); k, v (B, S, Hkv, D) with Hkv dividing Hq; pos (B,)
    int32, the valid cache length of each sequence → (B, Hq, D) in
    ``q.dtype``.  q head ``h`` attends to KV head ``h // (Hq // Hkv)``.

    Scores, softmax and the weighted sum are float32.  The domain is
    ``1 <= pos <= S``: at ``pos = 0`` every score is masked and this
    averages V over all S rows, as the JAX oracle does."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = torch.reciprocal(torch.sqrt(torch.tensor(float(D), device=q.device)))
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D) * scale
    s = torch.einsum("bghd,bsgd->bghs", qf, k.float())
    mask = torch.arange(S, device=q.device)[None, :] < pos.to(q.device)[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bghs,bsgd->bghd", p, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention_rel_err(got, want) -> float:
    """Max over sequences and q heads of |got - want| / |want|, L2 norms
    over the head dim, in float32: what ``ATTN_REL_TOL`` holds."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())
