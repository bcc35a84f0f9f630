"""Decoder-only transformer LM covering the five LM configurations of the
JAX package, with its serving entry points:

* dense GQA (mistral-large-123b, qwen2-1.5b, qwen1.5-4b — optional QKV bias)
* MoE (dbrx-132b: 16e top-4; deepseek-v2-lite: 64e top-6 + 2 shared, MLA)
* MLA latent attention (deepseek-v2-lite)

Parameters are a dict of tensors with the JAX package's tree leaf by leaf:
the layers' parameters are stacked on a leading axis ``(L, ...)`` under
``params["layers"]`` (and a MoE config's first dense layers under
``params["dense_layers"]``), and the layers run as a Python loop over views
of them (the JAX package scans them).

  init(cfg, generator=, device=)            → params
  forward(params, tokens, cfg, ...)         → (hidden, caches)
  loss_fn(params, batch, cfg)               → masked causal-LM cross-entropy
  prefill(params, tokens, cfg, max_seq=)    → (last-position logits, caches)
  decode_step(params, caches, tok, pos, cfg) → (logits, caches)

A training forward (no caches, autograd recording) recomputes each layer
in the backward, as the JAX package wraps each layer in ``jax.checkpoint``:
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` per layer.
``remat_policy="dots"`` keeps the outputs of the unbatched products
(``aten.mm`` / ``aten.addmm``, the ``dots_with_no_batch_dims_saveable``
policy); any other value (``"full"``) recomputes everything, as in the
JAX package.  Serving and ``torch.no_grad()`` calls run no checkpoint.

The caches are ``{"main" | "moe": entry, "dense": entry}`` (``"dense"`` for
a MoE config's first dense layers), each entry stacked over its layers: GQA
``{"k", "v"}`` (L, B, Smax, Hkv, D), MLA ``{"ckv"}`` (L, B, Smax, r) and
``{"kr"}`` (L, B, Smax, dr).  They are the large memory that decode streams:
a step writes only its new token's row, in place (the JAX package's
``dynamic_update_slice`` copies).  Prefill attends with
``nn.attention.gqa_attention``.  A GQA decode step attends with the
single-token kernel ``kernels.decode_attention`` over each layer's cache;
an MLA decode step materialises each layer's K and V from the whole latent
cache and attends with ``gqa_attention`` at ``q_offset = pos``, as the JAX
package does (the kernel takes no 192/128 head dims).  ``cfg.attn`` alone
picks the route.

Not here yet: a sliding window at decode (no configuration sets
``window``; the decode kernel raises on it).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention
from ..nn.attention import gqa_attention
from ..nn.mlp import draw_normal, swiglu, swiglu_specs
from ..nn.moe import MoECfg, moe_ffn, moe_specs
from ..nn.norms import rms_norm
from ..nn.rotary import apply_rope

INIT_STD = 0.02  # std of the attention weights and of the embedding at init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX package's ``LMConfig``, field for field.  ``unroll`` shapes
    the JAX traces only and changes nothing here; ``remat_policy`` picks
    what a training forward recomputes (module note)."""

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

    def moe_cfg(self) -> MoECfg:
        return MoECfg(
            num_experts=self.num_experts,
            top_k=self.top_k,
            d_model=self.d_model,
            d_ff_expert=self.d_ff_expert,
            n_shared=self.n_shared,
            capacity_factor=self.capacity_factor,
        )


def _stacks(cfg: LMConfig) -> list[tuple[str, str, int, bool]]:
    """The layer stacks in the order they run: (parameter key, cache key,
    layers, MoE blocks).  A MoE config's first dense layers run first."""
    if not cfg.moe:
        return [("layers", "main", cfg.n_layers, False)]
    dense = cfg.first_dense_layers
    stacks = [("dense_layers", "dense", dense, False)] if dense else []
    return stacks + [("layers", "moe", cfg.n_layers - dense, True)]


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def _attn_specs(cfg: LMConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    if cfg.attn == "mla":
        dn, dr, dv, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        return {
            "wq": ((d, H * (dn + dr)), INIT_STD),
            "w_dkv": ((d, r + dr), INIT_STD),
            "kv_norm": ((r,), "ones"),
            "w_uk": ((r, H * dn), INIT_STD),
            "w_uv": ((r, H * dv), INIT_STD),
            "wo": ((H * dv, d), INIT_STD),
        }
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    attn = {
        "wq": ((d, H * Dh), INIT_STD),
        "wk": ((d, Hkv * Dh), INIT_STD),
        "wv": ((d, Hkv * Dh), INIT_STD),
        "wo": ((H * Dh, d), INIT_STD),
    }
    if cfg.qkv_bias:
        attn.update({"bq": ((H * Dh,), "zeros"), "bk": ((Hkv * Dh,), "zeros"),
                     "bv": ((Hkv * Dh,), "zeros")})
    return attn


def _block_specs(cfg: LMConfig, moe_block: bool) -> dict:
    d = cfg.d_model
    block = {"pre_attn": ((d,), "ones"), "pre_ffn": ((d,), "ones"), "attn": _attn_specs(cfg)}
    if moe_block:
        block["moe"] = moe_specs(cfg.moe_cfg())
    else:
        block["ffn"] = swiglu_specs(d, cfg.d_ff)
    return block


def _stacked(spec: dict, n: int) -> dict:
    return {k: _stacked(v, n) if isinstance(v, dict) else ((n,) + tuple(v[0]), v[1])
            for k, v in spec.items()}


def param_specs(cfg: LMConfig) -> dict:
    """The parameter tree of ``init`` as ``{leaf: (shape, init)}``, where
    ``init`` is a normal draw's scale, ``"zeros"`` or ``"ones"``; every leaf
    has the dtype ``cfg.activation_dtype``.  The JAX package's shapes and
    scales, leaf by leaf."""
    specs = {"embed": ((cfg.vocab, cfg.d_model), INIT_STD), "final_norm": ((cfg.d_model,), "ones")}
    for key, _, n, moe_block in _stacks(cfg):
        specs[key] = _stacked(_block_specs(cfg, moe_block), n)
    return specs


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
def _attend(q, k, v, cfg: LMConfig, pos):
    return gqa_attention(
        q, k, v, causal=True, q_offset=0 if pos is None else pos, kv_block=cfg.kv_block,
        window=cfg.window, mixed=cfg.attn_mixed_precision, causal_skip=cfg.attn_causal_skip,
    )


def _mla_forward(p, x, cfg: LMConfig, positions, cache=None, pos=None):
    """MLA attention.  With a cache, the new latent rows are first written
    into ``cache["ckv"]`` (B, Smax, r) and ``cache["kr"]`` (B, Smax, dr) at
    ``pos`` in place; K and V are then materialised from the whole cache,
    the rope part of K broadcast over the heads."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)], dim=-1)
    ckv_kr = x @ p["w_dkv"]
    ckv = rms_norm(ckv_kr[..., :r], p["kv_norm"])
    kr = apply_rope(ckv_kr[..., r:], positions, cfg.rope_theta)
    if cache is not None:
        cache["ckv"][:, pos:pos + S] = ckv
        cache["kr"][:, pos:pos + S] = kr
        ckv, kr = cache["ckv"], cache["kr"]
    Skv = ckv.shape[1]
    k_nope = (ckv @ p["w_uk"]).reshape(B, Skv, H, dn)
    v = (ckv @ p["w_uv"]).reshape(B, Skv, H, dv)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, Skv, H, dr)], dim=-1)
    return _attend(q, k, v, cfg, pos).reshape(B, S, H * dv) @ p["wo"]


def _attn_forward(p, x, cfg: LMConfig, positions, cache=None, pos=None,
                  attention: Callable | None = None, lengths=None):
    """The attention block's output.  GQA: with a cache, the new K/V rows
    are first written into ``cache["k"/"v"]`` (B, Smax, Hkv, Dh) at ``pos``
    in place, and the whole cache is attended to.  ``attention(q[:, 0],
    k_cache, v_cache, lengths)`` is the single-token attention of a decode
    step; without it, ``gqa_attention`` attends."""
    if cfg.attn == "mla":
        return _mla_forward(p, x, cfg, positions, cache, pos)
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
        out = _attend(q, k, v, cfg, pos).reshape(B, S, H * Dh)
    return out @ p["wo"]


def _block(p, x, cfg: LMConfig, positions, moe_block: bool, cache=None, pos=None,
           attention=None, lengths=None):
    h = rms_norm(x, p["pre_attn"])
    x = x + _attn_forward(p["attn"], h, cfg, positions, cache, pos, attention, lengths)
    h = rms_norm(x, p["pre_ffn"])
    if moe_block:
        B, S, d = h.shape
        return x + moe_ffn(p["moe"], h.reshape(B * S, d), cfg.moe_cfg()).reshape(B, S, d)
    return x + swiglu(p["ffn"], h)


_UNBATCHED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the unbatched products."""
    if op in _UNBATCHED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(p, x, cfg: LMConfig, positions, moe_block: bool):
    """``_block`` of a training forward, recomputed in the backward."""
    if cfg.remat_policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(_block, p, x, cfg, positions, moe_block, use_reentrant=False,
                          context_fn=context)
    return checkpoint(_block, p, x, cfg, positions, moe_block, use_reentrant=False)


def forward(params, tokens, cfg: LMConfig, *, caches=None, pos: int | None = None,
            attention: Callable | None = None, collect_cache: bool = False):
    """tokens (B, S) → ``(hidden (B, S, d), caches)``; with ``caches`` the
    cache rows of positions ``pos .. pos+S-1`` are written into them in
    place (``caches`` comes back), else ``caches`` is None.
    ``collect_cache=True`` without ``caches`` returns the rows of all S
    positions as a fresh cache of S rows (the JAX package's stacked
    entries).

    ``attention`` (GQA only, with ``caches`` and S = 1) is the single-token
    attention of a decode step, called per layer as ``attention(q (B, Hq,
    Dh), k_cache, v_cache, lengths)`` with ``lengths`` (B,) int32 =
    ``pos + 1``."""
    B, S = tokens.shape
    if collect_cache and caches is None:
        if pos not in (None, 0):
            raise ValueError("collect_cache without caches starts at position 0")
        caches, pos = make_cache(cfg, B, S, device=tokens.device), 0
    x = params["embed"][tokens]
    base = 0 if pos is None else pos
    positions = base + torch.arange(S, device=tokens.device)[None, :]
    lengths = None
    if attention is not None:
        if cfg.attn == "mla":
            raise ValueError("an MLA decode step attends with gqa_attention over its "
                             "materialised K and V: it takes no single-token attention")
        if caches is None or S != 1:
            raise ValueError("a decode attention needs caches and one token per sequence")
        if cfg.window is not None:
            raise NotImplementedError("the decode attention kernel has no sliding window")
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=tokens.device)
    remat = caches is None and torch.is_grad_enabled()
    for key, cache_key, n, moe_block in _stacks(cfg):
        stack = None if caches is None else caches[cache_key]
        for i in range(n):
            lp = layer_params(params[key], i)
            if remat:
                x = _remat_block(lp, x, cfg, positions, moe_block)
                continue
            cache_l = None if stack is None else {k: t[i] for k, t in stack.items()}
            x = _block(lp, x, cfg, positions, moe_block, cache_l, pos, attention, lengths)
    return rms_norm(x, params["final_norm"]), caches


def logits_from_hidden(params, x, cfg: LMConfig):
    return x @ params["embed"].T  # tied embedding


def loss_fn(params, batch: dict, cfg: LMConfig) -> torch.Tensor:
    """Causal-LM cross-entropy; ``batch = {"tokens", "targets"}`` (B, S)
    integer ids.  The logits are taken in float32; a target ``< 0`` is
    masked out; the mean is over the unmasked positions (at least 1)."""
    x, _ = forward(params, batch["tokens"], cfg)
    logits = logits_from_hidden(params, x, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    targets = batch["targets"].long()
    tgt = torch.gather(logits, -1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    return torch.sum((lse - tgt) * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def make_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None, device=None) -> dict:
    """Zeroed caches with the JAX package's keys: ``{"main" | "moe": entry,
    "dense": entry}``, each entry GQA ``{"k", "v"}`` (L, B, Smax, Hkv, Dh) or
    MLA ``{"ckv"}`` (L, B, Smax, r) and ``{"kr"}`` (L, B, Smax, dr)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    if cfg.attn == "mla":
        rows = {"ckv": (cfg.kv_lora_rank,), "kr": (cfg.rope_head_dim,)}
    else:
        rows = {"k": (cfg.n_kv_heads, cfg.d_head), "v": (cfg.n_kv_heads, cfg.d_head)}
    return {cache_key: {name: torch.zeros((n, batch, max_seq) + row, dtype=dtype, device=dev)
                        for name, row in rows.items()}
            for _, cache_key, n, _ in _stacks(cfg)}


def prefill(params, tokens, cfg: LMConfig, *, max_seq: int | None = None):
    """Prefill: returns (last-position logits (B, V), caches), the caches
    allocated for ``max_seq`` positions (default the prompt's length) on
    the tokens' device."""
    B, S = tokens.shape
    caches = make_cache(cfg, B, max_seq or S, device=tokens.device)
    x, caches = forward(params, tokens, cfg, caches=caches, pos=0)
    return logits_from_hidden(params, x[:, -1:, :], cfg)[:, 0], caches


def decode_step(params, caches, tokens, pos: int, cfg: LMConfig, *,
                attention: Callable | None = None):
    """One decode step: tokens (B, 1) at absolute position ``pos``.  Returns
    (logits (B, V), caches), the caches updated in place.

    ``cfg.attn`` alone picks the route.  A GQA layer attends with
    ``attention(q, k_cache, v_cache, pos + 1)``: the kernel-backed
    ``decode_attention`` by default; ``decode_attention_ref`` gives the
    plain route that the kernel route is held to.  An MLA layer attends
    with ``gqa_attention`` over K and V materialised from its latent cache,
    at ``q_offset = pos``; passing ``attention`` for it raises."""
    if attention is None and cfg.attn != "mla":
        attention = decode_attention
    x, caches = forward(params, tokens, cfg, caches=caches, pos=pos, attention=attention)
    return logits_from_hidden(params, x, cfg)[:, 0], caches
