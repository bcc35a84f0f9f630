"""Attention: GQA (grouped KV) with a blockwise (flash-style) softmax, so the
S×S score matrix is never materialized.

Shapes: q (B, S, Hq, D), k/v (B, S, Hkv, D).  GQA groups the q heads by a
reshape to (B, S, Hkv, Hg, D); K/V are never repeated.

``mixed=True`` rounds the scaled q and the probabilities to the storage
dtype (bf16) before the two products, which then accumulate in float32 (the
products of bf16 values are exact in float32, so this is the JAX package's
``preferred_element_type=float32`` product); the softmax statistics stay
float32 either way.  ``mixed=False`` is the all-float32 baseline.

The single-token decode attention over a KV cache is the kernel
``repro_torch.kernels.decode_attention``; this module is the prefill path
and the reference the model's decode is held to.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_attn(q, k, v, *, causal: bool, q_offset: int, kv_block: int,
                window: int | None, mixed: bool = False):
    """Blockwise softmax attention.

    q: (B, Sq, G, Hg, D) — G kv-groups × Hg q-heads per group
    k: (B, Skv, G, D); v: (B, Skv, G, Dv)
    q_offset: absolute position of q[0] (for the causal mask in decode)
    Returns (B, Sq, G, Hg, Dv) in q's dtype.

    The last kv block may be short: the JAX package pads it with masked
    rows, which add exactly 0 once a row's running max is finite, and a
    causal row always sees position 0 first.
    """
    B, Sq, G, Hg, D = q.shape
    Skv = k.shape[1]
    Dv = v.shape[-1]
    dev = q.device
    kb = min(kv_block, Skv)
    scale = torch.reciprocal(torch.sqrt(torch.tensor(float(D), device=dev)))
    qs = q.float() * scale
    if mixed:
        qs = qs.to(q.dtype).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)

    acc = torch.zeros((B, Sq, G, Hg, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, G, Hg), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, G, Hg), dtype=torch.float32, device=dev)
    for base in range(0, Skv, kb):
        kb_i = k[:, base:base + kb].float()
        vb_i = v[:, base:base + kb].float()
        s = torch.einsum("bqghd,bkgd->bqghk", qs, kb_i)
        kv_pos = base + torch.arange(kb_i.shape[1], device=dev)
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((Sq, kb_i.shape[1]), dtype=torch.bool, device=dev)
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if mixed:
            p = p.to(v.dtype).float()
        pv = torch.einsum("bqghk,bkgd->bqghd", p, vb_i)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def _block_attn_causal_skip(q, k, v, *, kv_block: int, window, mixed: bool):
    """Flash-style 2D blocking for causal full-sequence attention (Sq == Skv,
    q_offset == 0): q is chunked, and each q chunk visits only the kv
    blocks that intersect its visible (lower-triangular) range."""
    Sq = q.shape[1]
    qb = min(kv_block, Sq)
    outs = []
    for lo in range(0, Sq, qb):
        hi = min(Sq, lo + qb)
        kv_hi = min(-(-hi // kv_block) * kv_block, Sq)
        outs.append(_block_attn(q[:, lo:hi], k[:, :kv_hi], v[:, :kv_hi], causal=True,
                                q_offset=lo, kv_block=kv_block, window=window,
                                mixed=mixed))
    return torch.cat(outs, dim=1)


def gqa_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_block: int = 1024,
    window: int | None = None,
    mixed: bool = False,
    causal_skip: bool = False,
) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads do not group over {Hkv} kv heads")
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    if causal_skip and causal and Sq > 1 and Sq == k.shape[1] and q_offset == 0:
        out = _block_attn_causal_skip(qg, k, v, kv_block=kv_block, window=window,
                                      mixed=mixed)
    else:
        out = _block_attn(qg, k, v, causal=causal, q_offset=q_offset, kv_block=kv_block,
                          window=window, mixed=mixed)
    return out.reshape(B, Sq, Hq, v.shape[-1])
