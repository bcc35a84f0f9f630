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
  param_shapes(cfg) / param_specs(cfg)      → each leaf's (shape, init) / logical axes
  cache_specs(cfg)                          → each cache leaf's logical axes
  forward(params, tokens, cfg, ...)         → (hidden, caches)
  loss_fn(params, batch, cfg)               → masked causal-LM cross-entropy
  loss_terms(params, batch, cfg)            → its (masked sum, count)
  loss_mask(batch)                          → the positions that count
  prefill(params, tokens, cfg, max_seq=)    → (last-position logits, caches)
  decode_step(params, caches, tok, pos, cfg) → (logits, caches)
  CacheSlice(lo, hi, max_seq, merge)        → a rank's slice of sharded caches
  TrainShard(layer, enter, leave, ...)      → a rank's part of a sharded training forward

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

Caches sharded along ``cache_seq`` (a ``ProcessMesh`` serving cell): with
``cache_slice=CacheSlice(lo, hi, max_seq, merge)``, ``prefill``,
``decode_step`` and ``forward`` take the rank's slice of every cache leaf,
positions [lo, hi) of ``max_seq``, (L, B, hi - lo, ...), and write only the
rows that fall in it, at ``position - lo``.  A decode step attends over the
slice's first ``clamp(pos + 1 - lo, 0, hi - lo)`` rows and ``merge`` (the
mesh's ``distributed.serving.merge_attention``) combines the ranks' float32
partials by their log-sum-exps before the one rounding: GQA through kernel 6
with ``return_lse=True``, MLA through ``nn.attention.partial_attention``
over K and V materialised from the slice's valid rows.  A sliced prefill
(from position 0) attends over the prompt's own rows, zero-padded to the
end of the last kv block that holds one, so its blocks are those of the
one-device prefill over ``max_seq`` rows (the rest are all masked and add
exactly 0).  ``vocab=(lo, hi)`` gives the logits' columns [lo, hi) alone:
the hidden state times those rows of the tied embedding.  Without a slice
every path is the one-device path.

A training forward on a process mesh (``shard=TrainShard(...)``, built by
``launch.steps``; this module imports nothing of ``distributed``):
``params["embed"]`` is the rank's vocabulary rows of the tied embedding
(``shard.lookup`` reads them) and ``params["final_norm"]`` the whole norm,
both gathered once a step; a layer's leaves come from ``shard.layer(key, i,
names)``, gathered one layer at a time inside the checkpointed function, so
the recompute gathers them again.  A layer runs as two checkpointed halves,
attention and FFN, each returning the rank's partial of its output, which
``shard.leave`` sums outside the checkpoint (the recompute runs no
all-reduce).  Column-parallel products (``wq``, ``wk``, ``wv``, the qkv
biases, ``w_gate``, ``w_up``, MLA's ``wq``, ``w_uk``, ``w_uv``) take
``shard.enter`` of their input, row-parallel ones (``wo``, ``w_down``) give
partials; the head counts are read from the gathered weights' widths.  MLA's
latent rows and their rope part enter after ``w_dkv`` and ``kv_norm``,
which every rank computes whole.  A MoE layer's ``moe`` subtree is gathered
whole and runs on the microbatch's rows of every rank (``shard.tokens``),
so its capacity and routing are the one-device step's; the rank keeps
``shard.rows`` of its output.  The logits are the rank's vocabulary columns
and ``shard.xent`` their cross-entropy.  ``shard=None`` runs the one-device
ops.

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
from ..nn.attention import gqa_attention, partial_attention
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


def param_shapes(cfg: LMConfig) -> dict:
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

    return make(param_shapes(cfg))


def layer_params(layers: dict, i: int) -> dict:
    """The parameters of layer ``i``: views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheSlice:
    """A rank's slice of caches sharded along ``cache_seq``: the caches it
    holds are positions [lo, hi) of ``max_seq``; ``merge(out, lse)`` combines
    the single-token attention's float32 partials (B, Hq, D) and (B, Hq)
    over the ranks into float32 (B, Hq, D)."""

    lo: int
    hi: int
    max_seq: int
    merge: Callable

    def length(self, pos: int) -> int:
        """Valid rows of the slice at a decode step at ``pos`` (its row
        written): ``clamp(pos + 1 - lo, 0, hi - lo)``."""
        return min(max(pos + 1 - self.lo, 0), self.hi - self.lo)


@dataclasses.dataclass(frozen=True)
class TrainShard:
    """A rank's part of a training forward on a process mesh (module note):
    ``layer(key, i, names, whole=())`` the subtrees ``names`` of layer i of
    the stack ``key`` gathered over the batch axes, and ``whole`` gathered
    over every axis; ``enter`` / ``leave`` a tensor-parallel group's entry
    (identity, its gradient summed) and exit (the partials summed);
    ``lookup(rows, ids)`` the embedding of global ids from the rank's rows
    of the tied embedding, whole on every rank; ``xent(logits, targets)``
    the per-position cross-entropy of the rank's float32 logit columns;
    ``tokens(h)`` a microbatch's rows (B, ...) from every rank of the batch
    axes, of which this rank's are ``rows``."""

    layer: Callable
    enter: Callable
    leave: Callable
    lookup: Callable
    xent: Callable
    tokens: Callable
    rows: tuple


def _attend(q, k, v, cfg: LMConfig, pos, causal_skip=None):
    return gqa_attention(
        q, k, v, causal=True, q_offset=0 if pos is None else pos, kv_block=cfg.kv_block,
        window=cfg.window, mixed=cfg.attn_mixed_precision,
        causal_skip=cfg.attn_causal_skip if causal_skip is None else causal_skip,
    )


def _write_slice(cache: dict, rows: dict, pos: int, lo: int):
    """Rows of positions [pos, pos + S) into a cache slice holding
    positions from ``lo``: only those that fall in the slice, at
    ``position - lo``, in place."""
    S = next(iter(rows.values())).shape[1]
    n = next(iter(cache.values())).shape[1]
    a, b = max(pos, lo), min(pos + S, lo + n)
    if a < b:
        for name, r in rows.items():
            cache[name][:, a - lo:b - lo] = r[:, a - pos:b - pos]


def _pad_rows(t, rows: int):
    """``t`` (B, S, ...) with zero rows appended up to ``rows``."""
    if t.shape[1] >= rows:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], rows - t.shape[1]) + tuple(t.shape[2:]))], 1)


def _prefill_rows(cfg: LMConfig, S: int, max_seq: int) -> int:
    """The rows a sliced prefill of S prompt tokens attends over: up to the
    end of the last kv block that holds one, as the one-device prefill's
    blocks over ``max_seq`` rows fall."""
    kb = min(cfg.kv_block, max_seq)
    return min(max_seq, -(-S // kb) * kb)


def _attend_prefill(q, k, v, cfg: LMConfig, max_seq: int):
    """A sliced prefill's attention (from position 0) over the prompt's own
    rows ``k``, ``v`` padded as ``_prefill_rows`` says: the one-device
    prefill's function block for block."""
    P = _prefill_rows(cfg, k.shape[1], max_seq)
    return _attend(q, _pad_rows(k, P), _pad_rows(v, P), cfg, 0,
                   causal_skip=cfg.attn_causal_skip and P == max_seq)


def _mla_kv(p, ckv, kr, cfg: LMConfig):
    """K (B, S, H, dn + dr) and V (B, S, H, dv) materialised from latent
    rows, the rope part of K broadcast over the heads."""
    B, Skv, _ = ckv.shape
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    H = p["w_uk"].shape[-1] // dn
    k_nope = (ckv @ p["w_uk"]).reshape(B, Skv, H, dn)
    v = (ckv @ p["w_uv"]).reshape(B, Skv, H, dv)
    return torch.cat([k_nope, kr[:, :, None, :].expand(B, Skv, H, dr)], dim=-1), v


def _mla_forward(p, x, cfg: LMConfig, positions, cache=None, pos=None, part=None,
                 shard=None):
    """MLA attention.  With a cache, the new latent rows are first written
    into ``cache["ckv"]`` (B, Smax, r) and ``cache["kr"]`` (B, Smax, dr) at
    ``pos`` in place; K and V are then materialised from the whole cache.
    With a ``CacheSlice`` ``part`` (module note) a decode step materialises
    them from the slice's valid rows and merges ``partial_attention``'s
    partials; a prefill attends over its own rows.  With a ``TrainShard``
    the rank's heads give a partial of the output."""
    B, S, _ = x.shape
    dn, dr, dv, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    H = p["wq"].shape[-1] // (dn + dr)
    q = ((x if shard is None else shard.enter(x)) @ p["wq"]).reshape(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)], dim=-1)
    ckv_kr = x @ p["w_dkv"]
    ckv = rms_norm(ckv_kr[..., :r], p["kv_norm"])
    kr = apply_rope(ckv_kr[..., r:], positions, cfg.rope_theta)
    if shard is not None:
        ckv, kr = shard.enter(ckv), shard.enter(kr)
    if part is not None:
        _write_slice(cache, {"ckv": ckv, "kr": kr}, pos, part.lo)
        if S == 1:
            n = part.length(pos)
            k, v = _mla_kv(p, cache["ckv"][:, :n], cache["kr"][:, :n], cfg)
            out = part.merge(*partial_attention(q[:, 0], k, v, n)).to(x.dtype)
            return out.reshape(B, 1, H * dv) @ p["wo"]
        P = _prefill_rows(cfg, S, part.max_seq)
        k, v = _mla_kv(p, _pad_rows(ckv, P), _pad_rows(kr, P), cfg)
        return _attend_prefill(q, k, v, cfg, part.max_seq).reshape(B, S, H * dv) @ p["wo"]
    if cache is not None:
        cache["ckv"][:, pos:pos + S] = ckv
        cache["kr"][:, pos:pos + S] = kr
        ckv, kr = cache["ckv"], cache["kr"]
    k, v = _mla_kv(p, ckv, kr, cfg)
    return _attend(q, k, v, cfg, pos).reshape(B, S, H * dv) @ p["wo"]


def _attn_forward(p, x, cfg: LMConfig, positions, cache=None, pos=None,
                  attention: Callable | None = None, lengths=None, part=None, shard=None):
    """The attention block's output.  GQA: with a cache, the new K/V rows
    are first written into ``cache["k"/"v"]`` (B, Smax, Hkv, Dh) at ``pos``
    in place, and the whole cache is attended to.  ``attention(q[:, 0],
    k_cache, v_cache, lengths)`` is the single-token attention of a decode
    step; without it, ``gqa_attention`` attends.  With a ``CacheSlice``
    ``part`` the rows go into the slice and a decode step merges
    ``attention(..., return_lse=True)``'s partials (module note).  With a
    ``TrainShard`` the rank's heads give a partial of the output."""
    if cfg.attn == "mla":
        return _mla_forward(p, x, cfg, positions, cache, pos, part, shard)
    B, S, _ = x.shape
    Dh = cfg.d_head
    H, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    if shard is not None:
        x = shard.enter(x)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, Dh)
    if part is not None:
        _write_slice(cache, {"k": k, "v": v}, pos, part.lo)
        if attention is None:
            return _attend_prefill(q, k, v, cfg, part.max_seq).reshape(B, S, H * Dh) @ p["wo"]
        out = part.merge(*attention(q[:, 0], cache["k"], cache["v"], lengths, return_lse=True))
        return out.to(x.dtype).reshape(B, 1, H * Dh) @ p["wo"]
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
           attention=None, lengths=None, part=None):
    h = rms_norm(x, p["pre_attn"])
    x = x + _attn_forward(p["attn"], h, cfg, positions, cache, pos, attention, lengths, part)
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


def _remat(cfg: LMConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``cfg.remat_policy``."""
    if cfg.remat_policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context)
    return checkpoint(fn, *args, use_reentrant=False)


def _remat_block(p, x, cfg: LMConfig, positions, moe_block: bool):
    """``_block`` of a training forward, recomputed in the backward."""
    return _remat(cfg, _block, p, x, cfg, positions, moe_block)


def _attn_half(x, cfg: LMConfig, positions, shard: TrainShard, key: str, i: int):
    """A sharded layer's attention half: its leaves gathered, the rank's
    partial of the attention output."""
    p = shard.layer(key, i, ("pre_attn", "attn"))
    return _attn_forward(p["attn"], rms_norm(x, p["pre_attn"]), cfg, positions, shard=shard)


def _ffn_half(x, cfg: LMConfig, moe_block: bool, shard: TrainShard, key: str, i: int):
    """A sharded layer's FFN half: the rank's partial of a SwiGLU's output,
    or a MoE layer's whole output at the rank's rows."""
    if not moe_block:
        p = shard.layer(key, i, ("pre_ffn", "ffn"))
        return swiglu(p["ffn"], shard.enter(rms_norm(x, p["pre_ffn"])))
    p = shard.layer(key, i, ("pre_ffn",), whole=("moe",))
    h = shard.tokens(rms_norm(x, p["pre_ffn"]))
    B, S, d = h.shape
    out = moe_ffn(p["moe"], h.reshape(B * S, d), cfg.moe_cfg()).reshape(B, S, d)
    return out[shard.rows[0]:shard.rows[1]]


def _sharded_block(x, cfg: LMConfig, positions, moe_block: bool, shard: TrainShard, key: str,
                   i: int, remat: bool):
    """Layer i of the stack ``key`` on a process mesh (module note)."""
    run = functools.partial(_remat, cfg) if remat else lambda fn, *a: fn(*a)
    x = x + shard.leave(run(_attn_half, x, cfg, positions, shard, key, i))
    out = run(_ffn_half, x, cfg, moe_block, shard, key, i)
    return x + (out if moe_block else shard.leave(out))


def forward(params, tokens, cfg: LMConfig, *, caches=None, pos: int | None = None,
            attention: Callable | None = None, collect_cache: bool = False,
            cache_slice: CacheSlice | None = None, shard: TrainShard | None = None):
    """tokens (B, S) → ``(hidden (B, S, d), caches)``; with ``caches`` the
    cache rows of positions ``pos .. pos+S-1`` are written into them in
    place (``caches`` comes back), else ``caches`` is None.
    ``collect_cache=True`` without ``caches`` returns the rows of all S
    positions as a fresh cache of S rows (the JAX package's stacked
    entries).

    ``attention`` (GQA only, with ``caches`` and S = 1) is the single-token
    attention of a decode step, called per layer as ``attention(q (B, Hq,
    Dh), k_cache, v_cache, lengths)`` with ``lengths`` (B,) int32 =
    ``pos + 1``.

    ``cache_slice`` (with ``caches`` the rank's slices): a decode step
    (S = 1) or a prefill from position 0; the lengths are the slice's
    (``CacheSlice.length``) and ``attention`` is called with
    ``return_lse=True`` (module note).

    ``shard`` (no caches): a training forward on a process mesh (module
    note); the hidden state comes back whole on every rank."""
    B, S = tokens.shape
    if shard is not None and caches is not None:
        raise ValueError("a sharded training forward takes no caches")
    if cache_slice is not None and (caches is None or (S > 1 and pos != 0)):
        raise ValueError("a cache slice takes caches, and a prefill into it starts at 0")
    if collect_cache and caches is None:
        if pos not in (None, 0):
            raise ValueError("collect_cache without caches starts at position 0")
        caches, pos = make_cache(cfg, B, S, device=tokens.device), 0
    x = params["embed"][tokens] if shard is None else shard.lookup(params["embed"], tokens)
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
        valid = pos + 1 if cache_slice is None else cache_slice.length(pos)
        lengths = torch.full((B,), valid, dtype=torch.int32, device=tokens.device)
    remat = caches is None and torch.is_grad_enabled()
    for key, cache_key, n, moe_block in _stacks(cfg):
        stack = None if caches is None else caches[cache_key]
        for i in range(n):
            if shard is not None:
                x = _sharded_block(x, cfg, positions, moe_block, shard, key, i, remat)
                continue
            lp = layer_params(params[key], i)
            if remat:
                x = _remat_block(lp, x, cfg, positions, moe_block)
                continue
            cache_l = None if stack is None else {k: t[i] for k, t in stack.items()}
            x = _block(lp, x, cfg, positions, moe_block, cache_l, pos, attention, lengths,
                       cache_slice)
    return rms_norm(x, params["final_norm"]), caches


def logits_from_hidden(params, x, cfg: LMConfig, vocab: tuple[int, int] | None = None,
                       shard: TrainShard | None = None):
    """Logits of the tied embedding; ``vocab=(lo, hi)``: columns [lo, hi)
    alone, from those rows of the embedding.  With a ``TrainShard`` the
    embedding is already the rank's rows: its columns alone."""
    if shard is not None:
        return shard.enter(x) @ params["embed"].T
    embed = params["embed"] if vocab is None else params["embed"][vocab[0]:vocab[1]]
    return x @ embed.T


def loss_terms(params, batch: dict, cfg: LMConfig,
               shard: TrainShard | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum, count)`` of the causal-LM cross-entropy over the unmasked
    positions of ``batch = {"tokens", "targets"}`` (B, S) integer ids: the
    logits taken in float32, a target ``< 0`` masked out.  A sharded step
    adds both terms over the ranks before it divides; with ``shard`` the
    logits are the rank's columns (module note)."""
    x, _ = forward(params, batch["tokens"], cfg, shard=shard)
    logits = logits_from_hidden(params, x, cfg, shard=shard).float()
    mask = loss_mask(batch)
    if shard is not None:
        return torch.sum(shard.xent(logits, batch["targets"]) * mask), torch.sum(mask)
    lse = torch.logsumexp(logits, dim=-1)
    targets = batch["targets"].long()
    tgt = torch.gather(logits, -1, targets.clamp(min=0)[..., None])[..., 0]
    return torch.sum((lse - tgt) * mask), torch.sum(mask)


def loss_mask(batch: dict) -> torch.Tensor:
    """(B, S) float32: 1 where the target counts (``>= 0``), else 0.  It
    reads the batch alone, so a sharded step counts before the forward."""
    return (batch["targets"] >= 0).float()


def loss_fn(params, batch: dict, cfg: LMConfig) -> torch.Tensor:
    """Causal-LM cross-entropy: the mean of ``loss_terms`` over the
    unmasked positions (at least 1)."""
    total, count = loss_terms(params, batch, cfg)
    return total / torch.clamp(count, min=1.0)


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


def prefill(params, tokens, cfg: LMConfig, *, max_seq: int | None = None,
            cache_slice: CacheSlice | None = None, vocab: tuple[int, int] | None = None):
    """Prefill: returns (last-position logits (B, V), caches), the caches
    allocated for ``max_seq`` positions (default the prompt's length) on
    the tokens' device.  With ``cache_slice`` the caches are the slice's
    rows [lo, hi) of ``cache_slice.max_seq``; with ``vocab`` the logits are
    its columns (module note)."""
    B, S = tokens.shape
    if cache_slice is None:
        caches = make_cache(cfg, B, max_seq or S, device=tokens.device)
    else:
        caches = make_cache(cfg, B, cache_slice.hi - cache_slice.lo, device=tokens.device)
    x, caches = forward(params, tokens, cfg, caches=caches, pos=0, cache_slice=cache_slice)
    return logits_from_hidden(params, x[:, -1:, :], cfg, vocab)[:, 0], caches


def decode_step(params, caches, tokens, pos: int, cfg: LMConfig, *,
                attention: Callable | None = None, cache_slice: CacheSlice | None = None,
                vocab: tuple[int, int] | None = None):
    """One decode step: tokens (B, 1) at absolute position ``pos``.  Returns
    (logits (B, V), caches), the caches updated in place.

    ``cfg.attn`` alone picks the route.  A GQA layer attends with
    ``attention(q, k_cache, v_cache, pos + 1)``: the kernel-backed
    ``decode_attention`` by default; ``decode_attention_ref`` gives the
    plain route that the kernel route is held to.  An MLA layer attends
    with ``gqa_attention`` over K and V materialised from its latent cache,
    at ``q_offset = pos``; passing ``attention`` for it raises.

    ``cache_slice`` and ``vocab``: the rank's cache slice and logits'
    columns (module note); ``attention`` then takes ``return_lse=True``."""
    if attention is None and cfg.attn != "mla":
        attention = decode_attention
    x, caches = forward(params, tokens, cfg, caches=caches, pos=pos, attention=attention,
                        cache_slice=cache_slice)
    return logits_from_hidden(params, x, cfg, vocab)[:, 0], caches


# ----------------------------------------------------------------------
# logical axes (the sharding rules' names) of every parameter and cache leaf
# ----------------------------------------------------------------------
def _attn_axes(cfg: LMConfig) -> dict:
    if cfg.attn == "mla":
        return {
            "wq": ("embed", "heads"),
            "w_dkv": ("embed", "kv_lora"),
            "kv_norm": ("kv_lora",),
            "w_uk": ("kv_lora", "heads"),
            "w_uv": ("kv_lora", "heads"),
            "wo": ("heads", "embed"),
        }
    axes = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "heads"),
        "wv": ("embed", "heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        axes.update({"bq": ("heads",), "bk": ("heads",), "bv": ("heads",)})
    return axes


def _block_axes(cfg: LMConfig, moe_block: bool) -> dict:
    ffn = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"), "w_down": ("ff", "embed")}
    block = {"pre_attn": ("embed",), "pre_ffn": ("embed",), "attn": _attn_axes(cfg)}
    if not moe_block:
        block["ffn"] = ffn
        return block
    block["moe"] = {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "embed", "expert_ff"),
        "w_up": ("experts", "embed", "expert_ff"),
        "w_down": ("experts", "expert_ff", "embed"),
    }
    if cfg.n_shared:
        block["moe"]["shared"] = ffn
    return block


def _layers_first(tree: dict) -> dict:
    return {k: _layers_first(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in tree.items()}


def param_specs(cfg: LMConfig) -> dict:
    """The logical axes of every parameter, a tree of ``init``'s structure
    whose leaves are tuples of logical names (the JAX package's
    ``param_specs``): the stacked layers lead with ``"layers"``."""
    specs = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}
    for key, _, _, moe_block in _stacks(cfg):
        specs[key] = _layers_first(_block_axes(cfg, moe_block))
    return specs


def cache_specs(cfg: LMConfig) -> dict:
    """The logical axes of every cache leaf (the JAX package's
    ``cache_specs``), keyed as ``make_cache``'s tree."""
    if cfg.attn == "mla":
        entry = {"ckv": ("layers", "batch", "cache_seq", "kv_lora"),
                 "kr": ("layers", "batch", "cache_seq", "head_dim")}
    else:
        entry = {"k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                 "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim")}
    return {cache_key: dict(entry) for _, cache_key, _, _ in _stacks(cfg)}
