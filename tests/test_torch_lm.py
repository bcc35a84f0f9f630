"""Port parity for the LM serving path: norms, rope, SwiGLU, blockwise GQA
attention, the single-token decode attention kernel's CPU route, and
qwen2-1.5b's prefill → decode against the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU; weights are the JAX package's ``init`` carried over with
``lm_params_from_reference``.  Tolerances, and why:

* float32, same arithmetic in another order (XLA's and PyTorch's reductions
  and products): rtol/atol 1e-5, for single ops and through the smoke
  model's two layers and vocab projection alike (its logits differ by
  ~2e-7 at a magnitude of ~0.5).
* bfloat16 results: the two frameworks round intermediate bf16 products at
  other places, which moves a result by a bf16 ulp (2^-8 relative): 2e-2
  for single ops, and 3e-2 for decode attention (the JAX sweep's own
  tolerance) and the bf16 model.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import assert_close as _close
from torch_parity import leaves as _leaves
from torch_parity import numpy_tree as _numpy_tree

from repro.configs import qwen2_1_5b as jqwen
from repro.kernels.decode_attention import decode_attention as jdecode_attention
from repro.kernels.decode_attention import decode_attention_ref as jdecode_ref
from repro.models import transformer_lm as jlm
from repro.nn.attention import gqa_attention as jgqa
from repro.nn.mlp import init_swiglu as jinit_swiglu
from repro.nn.mlp import swiglu as jswiglu
from repro.nn.norms import layer_norm as jlayer_norm
from repro.nn.norms import rms_norm as jrms_norm
from repro.nn.rotary import apply_rope as japply_rope
from repro_torch.configs import dbrx_132b, deepseek_v2_lite_16b
from repro_torch.configs import qwen2_1_5b as qwen
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.kernels import (
    ATTN_REL_TOL,
    decode_attention,
    decode_attention_ref,
    decode_attention_rel_err,
)
from repro_torch.kernels.decode_attention.decode_attention import split_count
from repro_torch.models import transformer_lm as lm
from repro_torch.nn import apply_rope, gqa_attention, init_swiglu, layer_norm, rms_norm, swiglu

CPU = "cpu"
F32_TOL = 1e-5
BF16_TOL = 2e-2
BF16_ATTN_TOL = 3e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a port tensor of ``dtype``."""
    return jnp.asarray(a, jnp.float32).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


# ---------------------------------------------------------------- nn
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = (_pair(a, dtype) for a in (x, scale, bias))
    got = rms_norm(tx, ts)
    assert got.dtype == TDT[dtype]
    _close(got, jrms_norm(jx, js), _tol(dtype))
    _close(layer_norm(tx, ts, tb), jlayer_norm(jx, js, jb), _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [True, False])
def test_apply_rope_matches_jax(dtype, heads):
    rng = np.random.default_rng(1)
    shape = (2, 7, 3, 16) if heads else (2, 7, 16)
    x = rng.normal(size=shape).astype(np.float32)
    positions = (57 + np.arange(7))[None, :].astype(np.int32)  # a position offset
    jx, tx = _pair(x, dtype)
    got = apply_rope(tx, torch.from_numpy(positions), 1_000_000.0)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    _close(got, japply_rope(jx, jnp.asarray(positions), 1_000_000.0), _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_jax(dtype):
    jp = jinit_swiglu(jax.random.PRNGKey(2), 48, 96, JDT[dtype])
    tp = {k: torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
          if v.dtype == np.uint16 else torch.from_numpy(v.copy())
          for k, v in _numpy_tree(jp).items()}
    x = np.random.default_rng(3).normal(size=(2, 5, 48)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _close(swiglu(tp, tx), jswiglu(jp, jx), _tol(dtype))
    # the port's own init: the JAX package's shapes, dtypes and scales
    own = init_swiglu(48, 96, generator=torch.Generator().manual_seed(0), dtype=TDT[dtype],
                      device=CPU)
    for k, v in jp.items():
        assert tuple(own[k].shape) == v.shape and own[k].dtype == TDT[dtype]
        fan_in = v.shape[0]
        assert abs(float(own[k].float().std()) * fan_in ** 0.5 - 1.0) < 0.1


ATTN_CASES = {
    "causal": dict(causal=True),
    "not causal": dict(causal=False),
    "q_offset": dict(causal=True, q_offset=37, skv=48),
    "kv_block not dividing S": dict(causal=True, kv_block=7),
    "window": dict(causal=True, window=5, kv_block=8),
    "causal_skip": dict(causal=True, causal_skip=True, kv_block=8),
    "causal_skip window": dict(causal=True, causal_skip=True, window=6, kv_block=8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_gqa_attention_matches_jax(case):
    kw = dict(ATTN_CASES[case])
    skv = kw.pop("skv", 29)
    sq = 11 if "q_offset" in kw else skv
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, sq, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    got = gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = jgqa(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("mixed", [False, True])
def test_gqa_attention_bf16_matches_jax(mixed):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 21, h, 16)).astype(np.float32) for h in (6, 2, 2))
    pairs = [_pair(a, "bfloat16") for a in (q, k, v)]
    got = gqa_attention(*(t for _, t in pairs), q_offset=3, kv_block=8, mixed=mixed)
    want = jgqa(*(j for j, _ in pairs), q_offset=3, kv_block=8, mixed=mixed)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


# ---------------------------------------------------------------- kernel 6, CPU route
SWEEP = [(2, 64, 4, 4, 8), (6, 300, 8, 2, 16), (3, 128, 6, 1, 32)]


def _lengths(B, S, seed):
    """pos in [1, S] for every sequence: 1, S and a tile boundary (64) among
    them, the rest random."""
    pos = np.random.default_rng(seed).integers(1, S + 1, B).astype(np.int32)
    pos[0], pos[-1] = 1, S
    if B > 2:
        pos[1] = 64
    return pos


@pytest.mark.parametrize("B,S,Hq,Hkv,D", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(B, S, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(B * S)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    pos = _lengths(B, S, S)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    got = decode_attention(tq, tk, tv, tpos)
    plain = decode_attention_ref(tq, tk, tv, tpos)
    assert got.dtype == TDT[dtype] and got.shape == (B, Hq, D)
    jkern = jdecode_attention(jq, jk, jv, jnp.asarray(pos), seq_tile=64, tile_batch=2,
                              interpret=True)
    rep = Hq // Hkv
    jref = jdecode_ref(jq, jnp.repeat(jk, rep, axis=2), jnp.repeat(jv, rep, axis=2),
                       jnp.asarray(pos))
    tol = F32_TOL if dtype == "float32" else BF16_ATTN_TOL
    _close(got, jkern, tol)
    _close(got, jref, tol)
    _close(plain, jref, tol)
    for want in (jkern, jref):  # and row by row, on the output's own scale
        want = torch.from_numpy(np.array(want, np.float32))
        assert decode_attention_rel_err(got, want) <= ATTN_REL_TOL[TDT[dtype]]


# what a test plants at and past each sequence's pos: NaN K rows, finite
# garbage V rows, and NaN V rows
PLANTS = [("k", np.nan), ("v", 3e4), ("v", np.nan)]


@pytest.mark.parametrize("which,value", PLANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_past_pos_reach_no_output(which, value, dtype):
    """The cache rows at and past ``pos`` against the plain version and the
    JAX kernel in interpret mode (and its oracle).  A K row there is masked
    by its score, so NaN K rows change nothing; a V row there is weighted
    by p = 0, so finite garbage changes nothing.  A NaN V row is the one
    content that reaches both references (0 · NaN is NaN), and both alike:
    the card's kernel never reads those rows (``tests/test_torch_cuda.py``)."""
    B, S, Hq, Hkv, D = 3, 100, 6, 2, 16
    rng = np.random.default_rng(21)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    pos = np.array([1, 37, 64], np.int32)   # 1, mid-tile, a tile boundary; all < S
    planted = {"k": k.copy(), "v": v.copy()}
    for b in range(B):
        planted[which][b, pos[b]:] = value
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, planted["k"], planted["v"]))
    tpos = torch.from_numpy(pos)
    got = decode_attention(tq, tk, tv, tpos)   # the CPU route: the plain version
    jkern = np.asarray(jdecode_attention(jq, jk, jv, jnp.asarray(pos), seq_tile=32,
                                         tile_batch=2, interpret=True), np.float32)
    rep = Hq // Hkv
    joracle = np.asarray(jdecode_ref(jq, jnp.repeat(jk, rep, axis=2),
                                     jnp.repeat(jv, rep, axis=2), jnp.asarray(pos)), np.float32)
    if which == "v" and np.isnan(value):
        # every sequence is NaN in all three: each has rows past its pos
        for out in (got.float().numpy(), jkern, joracle):
            assert np.isnan(out).any(axis=(1, 2)).all()
        return
    clean = decode_attention_ref(*(_pair(a, dtype)[1] for a in (q, k, v)), tpos)
    tol = F32_TOL if dtype == "float32" else BF16_ATTN_TOL
    assert bool(torch.isfinite(got.float()).all())
    _close(got, clean.float().numpy(), 0.0)
    _close(got, jkern, tol)
    _close(got, joracle, tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,resident,want", [
    (32, 32768, 12, 2, 396, 24),    # 1,536 CTAs: four waves of 396, the last 88 % full
    (8, 1024, 12, 2, 396, 8),       # capped: no split under 128 rows
    (2, 100, 4, 4, 396, 1),         # shorter than one split
    (64, 4096, 64, 8, 132, 1),      # more CTAs than four waves without splitting
    (4, 777, 20, 20, 660, 6),       # MHA: one head a CTA
    (32, 32768, 12, 2, 132, 8),     # the tensor-core kernel's one CTA an SM: 512 CTAs
])
def test_split_count(B, S, Hq, Hkv, resident, want):
    assert split_count(B, Hq, Hkv, S, resident) == want


def _one_row_short(q, k, v, pos):
    return decode_attention_ref(q, k, v, pos - 1)


def _split_dropped(q, k, v, pos, rows=32768 // 8):
    """The second of the 8 splits qwen2-1.5b's long-context shape takes on
    an H100 left out (``test_split_count``'s last case)."""
    keep = torch.cat([torch.arange(rows), torch.arange(2 * rows, k.shape[1])])
    return decode_attention_ref(q, k[:, keep], v[:, keep], pos - rows)


def _wrong_kv_head(q, k, v, pos):
    b, hq, d = q.shape
    q = q.reshape(b, hq // k.shape[2], k.shape[2], d).transpose(1, 2).reshape(b, hq, d)
    return decode_attention_ref(q, k, v, pos)


@pytest.mark.parametrize("fault", [_one_row_short, _split_dropped, _wrong_kv_head])
def test_attention_limit_rejects_faults(fault):
    """At qwen2-1.5b's long-context shape (batch cut to 2) a bfloat16 output
    row is ~0.1 in norm, under the 3e-2 an element that a max abs limit
    would allow; ``ATTN_REL_TOL`` scales with the row and still rejects
    these faults there, while the plain version rounded from float64 sums
    stays inside it."""
    rng = np.random.default_rng(32768)
    B, S, Hq, Hkv, D = 2, 32768, 12, 2, 128
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
               for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    pos = torch.full((B,), S, dtype=torch.int32)
    want = decode_attention_ref(q, k, v, pos)
    qd = q.double().reshape(B, Hkv, Hq // Hkv, D) / D ** 0.5
    p = torch.einsum("bghd,bsgd->bghs", qd, k.double()).softmax(dim=-1)
    exact = torch.einsum("bghs,bsgd->bghd", p, v.double()).reshape(B, Hq, D).bfloat16()
    assert decode_attention_rel_err(exact, want) <= ATTN_REL_TOL[torch.bfloat16]
    assert decode_attention_rel_err(fault(q, k, v, pos), want) > ATTN_REL_TOL[torch.bfloat16]


def test_decode_attention_cpu_route_launches_nothing():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 6, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 10, 2, 8)).astype(np.float32))
    before = decode_attention.launches
    decode_attention(q, k, k, torch.tensor([3, 10], dtype=torch.int32))
    assert decode_attention.launches == before


def test_decode_attention_is_model_decode_attention():
    """The single-token attention over pos + 1 rows equals the model's
    blockwise attention at q_offset=pos (the JAX package's own identity)."""
    rng = np.random.default_rng(7)
    B, S, Hq, Hkv, D, pos = 2, 96, 4, 2, 16, 57
    q = torch.from_numpy(rng.normal(size=(B, 1, Hq, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
            for _ in range(2))
    model = gqa_attention(q, k, v, causal=True, q_offset=pos, kv_block=32)[:, 0]
    kern = decode_attention(q[:, 0], k, v, torch.full((B,), pos + 1, dtype=torch.int32))
    _close(kern, model.numpy(), F32_TOL)


# ---------------------------------------------------------------- qwen2-1.5b
def test_full_config_matches_jax():
    assert dataclasses.asdict(qwen.full_config()) == dataclasses.asdict(jqwen.full_config())
    assert dataclasses.asdict(qwen.smoke_config()) == dataclasses.asdict(jqwen.smoke_config())
    assert qwen.full_config().q_dim == jqwen.full_config().q_dim


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_init_tree_matches_jax(which):
    jcfg = getattr(jqwen, f"{which}_config")()
    cfg = getattr(qwen, f"{which}_config")()
    want = _leaves(jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg)))
    specs = _leaves(lm.param_specs(cfg))
    assert set(specs) == set(want)
    for name, (shape, _) in specs.items():
        assert tuple(shape) == want[name].shape, name
        assert str(want[name].dtype) == cfg.dtype, name
    if which == "smoke":
        got = _leaves(lm.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU))
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape and t.dtype == cfg.activation_dtype


def _carry(jcfg, cfg):
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    return jparams, lm_params_from_reference(_numpy_tree(jparams), cfg, CPU)


def test_converter_is_exact_and_raises_on_a_bad_tree():
    jcfg = dataclasses.replace(jqwen.smoke_config(), dtype="bfloat16")
    cfg = dataclasses.replace(qwen.smoke_config(), dtype="bfloat16")
    jparams, params = _carry(jcfg, cfg)
    for name, t in _leaves(params).items():
        want = _leaves(_numpy_tree(jparams))[name]
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), want), name
    tree = _numpy_tree(jparams)
    bad = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="differ"):
        lm_params_from_reference(bad, cfg, CPU)
    with pytest.raises(ValueError, match="differ"):
        lm_params_from_reference({**tree, "extra": tree["final_norm"]}, cfg, CPU)
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_reference({**tree, "final_norm": tree["final_norm"][:-1]}, cfg, CPU)
    with pytest.raises(TypeError, match="dtype"):
        lm_params_from_reference({**tree, "final_norm": tree["final_norm"].astype(np.float32)},
                                 cfg, CPU)
    with pytest.raises(TypeError, match="dtype"):   # bf16 bits into a float32 config
        lm_params_from_reference(tree, qwen.smoke_config(), CPU)


def _caches_close(got, want, tol):
    for name in ("k", "v"):
        _close(got["main"][name], want["main"][name], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    jcfg = dataclasses.replace(jqwen.smoke_config(), dtype=dtype)
    cfg = dataclasses.replace(qwen.smoke_config(), dtype=dtype)
    jparams, params = _carry(jcfg, cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jtoks, ttoks = jnp.asarray(toks), torch.from_numpy(toks).long()
    tol = F32_TOL if dtype == "float32" else BF16_ATTN_TOL
    jlogits, jcache = jlm.prefill(jparams, jtoks[:, :8], jcfg, max_seq=12)
    logits, cache = lm.prefill(params, ttoks[:, :8], cfg, max_seq=12)
    assert logits.dtype == TDT[dtype] and cache["main"]["k"].shape == (2, 2, 12, 2, 8)
    _close(logits, jlogits, tol)
    _caches_close(cache, jcache, tol)
    for step in range(4):  # teacher-forced: both decode the same tokens
        p = 8 + step
        jlogits, jcache = jlm.decode_step(jparams, jcache, jtoks[:, p:p + 1], p, jcfg)
        logits, cache2 = lm.decode_step(params, cache, ttoks[:, p:p + 1], p, cfg)
        assert cache2 is cache  # written in place
        _close(logits, jlogits, tol)
        _caches_close(cache, jcache, tol)


def test_decode_step_matches_teacher_forced_forward():
    cfg = qwen.smoke_config()
    params = lm.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab, (2, 12)))
    h, caches = lm.forward(params, toks, cfg)
    assert caches is None
    ref = lm.logits_from_hidden(params, h, cfg)
    logits, cache = lm.prefill(params, toks[:, :8], cfg, max_seq=12)
    _close(logits, ref[:, 7].numpy(), F32_TOL)
    for p in range(8, 12):
        logits, cache = lm.decode_step(params, cache, toks[:, p:p + 1], p, cfg)
        _close(logits, ref[:, p].numpy(), F32_TOL)
        # the plain route of the same step: the same logits
        again, _ = lm.decode_step(params, {"main": {k: t.clone() for k, t in
                                                    cache["main"].items()}},
                                  toks[:, p:p + 1], p, cfg, attention=decode_attention_ref)
        _close(again, logits.numpy(), F32_TOL)


@pytest.mark.parametrize("field,value", [("moe", True), ("attn", "mla")])
def test_later_slices_raise(field, value):
    """MoE and MLA configs serve (``tests/test_torch_moe_lm.py``); what the
    decode kernel does not take yet raises: a sliding window at decode (on
    dbrx's MoE config), and a single-token attention for an MLA layer
    (deepseek-v2-lite), which attends with ``gqa_attention`` over its
    materialised K and V."""
    arch = {"moe": dbrx_132b, "attn": deepseek_v2_lite_16b}[field]
    cfg = arch.smoke_config()
    assert getattr(cfg, field) == value
    params = lm.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    toks = torch.zeros((1, 4), dtype=torch.long)
    _, cache = lm.prefill(params, toks, cfg, max_seq=5)
    if field == "moe":
        with pytest.raises(NotImplementedError, match="window"):
            lm.decode_step(params, cache, toks[:, :1], 4, dataclasses.replace(cfg, window=2))
    else:
        with pytest.raises(ValueError, match="MLA"):
            lm.decode_step(params, cache, toks[:, :1], 4, cfg, attention=decode_attention)
