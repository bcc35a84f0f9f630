"""Decoder-only transformer LM: the dense GQA path (qwen2-1.5b, qwen1.5-4b,
mistral-large-123b), with its serving entry points.

Parameters are a dict of tensors with the JAX package's tree leaf by leaf:
the layers' parameters are stacked on a leading axis ``(L, ...)`` under
``params["layers"]``, and the layers run as a Python loop over views of it
(the JAX package scans them).  Serving needs no remat.

  init(cfg, generator=, device=)            → params
  forward(params, tokens, cfg, ...)         → (hidden, caches)
  prefill(params, tokens, cfg, max_seq=)    → (last-position logits, caches)
  decode_step(params, caches, tok, pos, cfg) → (logits, caches)

The KV cache ``caches["main"]["k"/"v"]`` is (L, B, Smax, Hkv, D).  It is the
large memory that decode streams read-only: a step writes only its new
token's row, in place (the JAX package's ``dynamic_update_slice`` copies).
Prefill attends with ``nn.attention.gqa_attention``; a decode step with the
single-token kernel ``kernels.decode_attention`` over each layer's cache.

Not here yet: MoE blocks and MLA attention (``moe=True``, ``attn="mla"``
raise ``NotImplementedError``) and the training loss.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention
from ..nn.attention import gqa_attention
from ..nn.mlp import draw_normal, swiglu, swiglu_specs
from ..nn.norms import rms_norm
from ..nn.rotary import apply_rope

INIT_STD = 0.02  # std of the attention weights and of the embedding at init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX package's ``LMConfig``, field for field.  ``unroll`` and
    ``remat_policy`` shape the JAX traces only and change nothing here."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None
    # attention flavor
    attn: str = "gqa"  # "gqa" | "mla"
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # numerics
    dtype: str = "bfloat16"
    # attention kv block for blockwise softmax
    kv_block: int = 1024
    unroll: bool = False
    # bf16 operands and float32 accumulation in the prefill attention products
    attn_mixed_precision: bool = False
    # flash-style causal block skipping: only visit visible kv blocks
    attn_causal_skip: bool = False
    remat_policy: str = "full"

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        if self.attn == "mla":
            return self.n_heads * (self.nope_head_dim + self.rope_head_dim)
        return self.n_heads * self.d_head


def _check_supported(cfg: LMConfig) -> None:
    if cfg.moe:
        raise NotImplementedError("MoE blocks (dbrx, deepseek-v2-lite) come with a later "
                                  "slice of the port: nn/moe.py")
    if cfg.attn != "gqa":
        raise NotImplementedError("MLA attention (deepseek-v2-lite) comes with a later "
                                  "slice of the port")


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def param_specs(cfg: LMConfig) -> dict:
    """The parameter tree of ``init`` as ``{leaf: (shape, init)}``, where
    ``init`` is a normal draw's scale, ``"zeros"`` or ``"ones"``; every leaf
    has the dtype ``cfg.activation_dtype``.  The JAX package's shapes and
    scales, leaf by leaf."""
    _check_supported(cfg)
    L, d = cfg.n_layers, cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = {
        "wq": ((L, d, H * Dh), INIT_STD),
        "wk": ((L, d, Hkv * Dh), INIT_STD),
        "wv": ((L, d, Hkv * Dh), INIT_STD),
        "wo": ((L, H * Dh, d), INIT_STD),
    }
    if cfg.qkv_bias:
        attn.update({"bq": ((L, H * Dh), "zeros"), "bk": ((L, Hkv * Dh), "zeros"),
                     "bv": ((L, Hkv * Dh), "zeros")})
    ffn = {k: ((L,) + shape, scale) for k, (shape, scale) in swiglu_specs(d, cfg.d_ff).items()}
    return {
        "embed": ((cfg.vocab, d), INIT_STD),
        "final_norm": ((d,), "ones"),
        "layers": {
            "pre_attn": ((L, d), "ones"),
            "pre_ffn": ((L, d), "ones"),
            "attn": attn,
            "ffn": ffn,
        },
    }


def init(cfg: LMConfig, *, generator: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``, default ``cuda``).  A torch generator does not give a JAX
    key's numbers: the parity tests carry the JAX package's weights over
    with ``core.convert.lm_params_from_reference``."""
    dev = resolve_device(device)
    dtype = cfg.activation_dtype

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, how = spec
        if how == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if how == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        return draw_normal(shape, how, generator=generator, dtype=dtype, device=dev)

    return make(param_specs(cfg))


def layer_params(layers: dict, i: int) -> dict:
    """The parameters of layer ``i``: views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def _attn_forward(p, x, cfg: LMConfig, positions, cache=None, pos=None,
                  attention: Callable | None = None, lengths=None):
    """The attention block's output.  With a cache, the new K/V rows are
    first written into ``cache["k"/"v"]`` (B, Smax, Hkv, Dh) at ``pos`` in
    place, and the whole cache is attended to.  ``attention(q[:, 0],
    k_cache, v_cache, lengths)`` is the single-token attention of a decode
    step; without it, ``gqa_attention`` attends."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, Dh)
    if cache is not None:
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        k, v = cache["k"], cache["v"]
    if attention is not None:
        out = attention(q[:, 0], k, v, lengths).reshape(B, 1, H * Dh)
    else:
        out = gqa_attention(
            q, k, v, causal=True, q_offset=0 if pos is None else pos, kv_block=cfg.kv_block,
            window=cfg.window, mixed=cfg.attn_mixed_precision,
            causal_skip=cfg.attn_causal_skip,
        ).reshape(B, S, H * Dh)
    return out @ p["wo"]


def _block(p, x, cfg: LMConfig, positions, cache=None, pos=None, attention=None,
           lengths=None):
    h = rms_norm(x, p["pre_attn"])
    x = x + _attn_forward(p["attn"], h, cfg, positions, cache, pos, attention, lengths)
    h = rms_norm(x, p["pre_ffn"])
    return x + swiglu(p["ffn"], h)


def forward(params, tokens, cfg: LMConfig, *, caches=None, pos: int | None = None,
            attention: Callable | None = None):
    """tokens (B, S) → ``(hidden (B, S, d), caches)``; with ``caches`` the
    K/V rows of positions ``pos .. pos+S-1`` are written into them in place
    (``caches`` comes back), else ``caches`` is None.

    ``attention`` (with ``caches`` and S = 1) is the single-token attention
    of a decode step, called per layer as ``attention(q (B, Hq, Dh),
    k_cache, v_cache, lengths)`` with ``lengths`` (B,) int32 = ``pos + 1``."""
    _check_supported(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens]
    base = 0 if pos is None else pos
    positions = base + torch.arange(S, device=tokens.device)[None, :]
    lengths = None
    if attention is not None:
        if caches is None or S != 1:
            raise ValueError("a decode attention needs caches and one token per sequence")
        if cfg.window is not None:
            raise NotImplementedError("the decode attention kernel has no sliding window")
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=tokens.device)
    main = None if caches is None else caches["main"]
    for i in range(cfg.n_layers):
        cache_l = None if main is None else {"k": main["k"][i], "v": main["v"][i]}
        x = _block(layer_params(params["layers"], i), x, cfg, positions, cache_l, pos,
                      attention, lengths)
    return rms_norm(x, params["final_norm"]), caches


def logits_from_hidden(params, x, cfg: LMConfig):
    return x @ params["embed"].T  # tied embedding


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def make_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None, device=None) -> dict:
    """Zeroed KV caches ``{"main": {"k", "v"}}``, each (L, B, Smax, Hkv, Dh)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.activation_dtype
    return {"main": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def prefill(params, tokens, cfg: LMConfig, *, max_seq: int | None = None):
    """Prefill: returns (last-position logits (B, V), caches), the caches
    allocated for ``max_seq`` positions (default the prompt's length) on
    the tokens' device."""
    B, S = tokens.shape
    caches = make_cache(cfg, B, max_seq or S, device=tokens.device)
    x, caches = forward(params, tokens, cfg, caches=caches, pos=0)
    return logits_from_hidden(params, x[:, -1:, :], cfg)[:, 0], caches


def decode_step(params, caches, tokens, pos: int, cfg: LMConfig, *,
                attention: Callable = decode_attention):
    """One decode step: tokens (B, 1) at absolute position ``pos``.  Returns
    (logits (B, V), caches), the caches updated in place.

    Each layer attends with ``attention(q, k_cache, v_cache, pos + 1)``: the
    kernel-backed ``decode_attention`` by default; ``decode_attention_ref``
    gives the plain route that the kernel route is held to."""
    x, caches = forward(params, tokens, cfg, caches=caches, pos=pos, attention=attention)
    return logits_from_hidden(params, x, cfg)[:, 0], caches
