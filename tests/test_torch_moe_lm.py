"""Port parity for the MoE and MLA language models (deepseek-v2-lite-16b,
dbrx-132b) and the configurations of the four LMs the port added beside
qwen2-1.5b: MLA's attention shapes, the configs field for field, the
``init`` trees, the converter, ``prefill`` and teacher-forced
``decode_step`` with their caches, and ``forward(collect_cache=True)``,
against the JAX package's ``repro.models.transformer_lm``.

Inputs are made with numpy from a seed and go through both packages on the
CPU; weights are the JAX package's ``init`` carried over with
``lm_params_from_reference``.  Tolerances, and why:

* float32: the same arithmetic in another order: rtol/atol 1e-5.
* bfloat16: the two frameworks round intermediate bf16 products at other
  places, which moves a result by a bf16 ulp (2^-8 relative): 2e-2 for
  MLA's attention; 3e-2 for a model's logits (as ``test_torch_lm.py``).
  A model's cache rows are held by the row: relative L2 within 5e-2 (13
  ulps).  An MLA latent row is a low-rank projection of the hidden state
  renormalised by ``rms_norm``, which turns a one-ulp move of the layer
  below's attention output into ~3 % of a row (2.7 % at most in these
  tests, element for element up to 0.06), while ``moe_ffn`` itself is bit
  for bit JAX's on equal bf16 inputs.
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

from repro.configs import dbrx_132b as jdbrx
from repro.configs import deepseek_v2_lite_16b as jdeepseek
from repro.configs import mistral_large_123b as jmistral
from repro.configs import qwen1_5_4b as jqwen4b
from repro.models import transformer_lm as jlm
from repro.nn.attention import gqa_attention as jgqa
from repro_torch.configs import dbrx_132b, deepseek_v2_lite_16b, mistral_large_123b, qwen1_5_4b
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.kernels import decode_attention_ref
from repro_torch.models import transformer_lm as lm
from repro_torch.nn import gqa_attention

CPU = "cpu"
F32_TOL = 1e-5
BF16_TOL = 2e-2
BF16_MODEL_TOL = 3e-2
BF16_ROW_TOL = 5e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONFIGS = {  # ARCH_ID: (the JAX module, the port's)
    "deepseek-v2-lite-16b": (jdeepseek, deepseek_v2_lite_16b),
    "dbrx-132b": (jdbrx, dbrx_132b),
    "qwen1.5-4b": (jqwen4b, qwen1_5_4b),
    "mistral-large-123b": (jmistral, mistral_large_123b),
}
MOE_ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b"]


def _pair(a, dtype):
    """The same numpy values as a JAX array and a port tensor of ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(JDT[dtype]),
            torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype]))


# ---------------------------------------------------------------- MLA attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "causal_skip", "q_offset"])
def test_mla_shapes_gqa_attention_matches_jax(variant, dtype):
    """MLA's attention shapes: D = nope + rope, Dv = v_head_dim, Hkv = H."""
    H, dn, dr, dv = 4, 16, 8, 12
    skv = 40
    sq = 1 if variant == "q_offset" else skv
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, sq, H, dn + dr)).astype(np.float32)
    k = rng.normal(size=(2, skv, H, dn + dr)).astype(np.float32)
    v = rng.normal(size=(2, skv, H, dv)).astype(np.float32)
    kw = dict(causal=True, kv_block=16, causal_skip=variant == "causal_skip",
              q_offset=29 if variant == "q_offset" else 0)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    got = gqa_attention(tq, tk, tv, **kw)
    want = jgqa(jq, jk, jv, **kw)
    assert tuple(got.shape) == (2, sq, H, dv) and got.dtype == TDT[dtype]
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


# ---------------------------------------------------------------- configs and trees
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_configs_match_jax(arch):
    jm, m = CONFIGS[arch]
    assert (m.ARCH_ID, m.FAMILY) == (jm.ARCH_ID, jm.FAMILY) == (arch, "lm")
    assert m.MODULE is lm
    for which in ("full_config", "smoke_config"):
        got, want = getattr(m, which)(), getattr(jm, which)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), which
        assert got.q_dim == want.q_dim
        if got.moe:
            assert dataclasses.asdict(got.moe_cfg()) == dataclasses.asdict(want.moe_cfg())


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_init_tree_matches_jax(arch, which):
    jm, m = CONFIGS[arch]
    jcfg, cfg = getattr(jm, f"{which}_config")(), getattr(m, f"{which}_config")()
    want = _leaves(jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg)))
    specs = _leaves(lm.param_shapes(cfg))
    assert set(specs) == set(want)
    for name, (shape, _) in specs.items():
        assert tuple(shape) == want[name].shape, name
        assert str(want[name].dtype) == cfg.dtype, name
    if which == "smoke":
        got = _leaves(lm.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU))
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape and t.dtype == cfg.activation_dtype


def _configs(arch, dtype, **changes):
    jm, m = CONFIGS[arch]
    return (dataclasses.replace(jm.smoke_config(), dtype=dtype, **changes),
            dataclasses.replace(m.smoke_config(), dtype=dtype, **changes))


_jinit = jax.jit(jlm.init, static_argnums=(1,))


def _carry(jcfg, cfg):
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    return jparams, lm_params_from_reference(_numpy_tree(jparams), cfg, CPU)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_converter_carries_moe_and_mla_trees(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    jparams, params = _carry(jcfg, cfg)
    tree = _numpy_tree(jparams)
    want = _leaves(tree)
    got = _leaves(params)
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), want[name]), name
    if arch == "deepseek-v2-lite-16b":
        assert {"/dense_layers/ffn/w_gate", "/layers/moe/shared/w_down",
                "/layers/attn/kv_norm"} <= set(got)
    layers = tree["layers"]
    no_router = {**layers, "moe": {k: v for k, v in layers["moe"].items() if k != "router"}}
    with pytest.raises(ValueError, match="differ"):
        lm_params_from_reference({**tree, "layers": no_router}, cfg, CPU)
    extra = {**layers, "attn": {**layers["attn"], "wk": layers["attn"]["wo"]}}
    if arch == "deepseek-v2-lite-16b":   # an MLA tree takes no wk
        with pytest.raises(ValueError, match="differ"):
            lm_params_from_reference({**tree, "layers": extra}, cfg, CPU)
    short = {**layers, "moe": {**layers["moe"], "w_down": layers["moe"]["w_down"][:, :-1]}}
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_reference({**tree, "layers": short}, cfg, CPU)
    if "dense_layers" in tree:
        del tree["dense_layers"]
        with pytest.raises(ValueError, match="differ"):
            lm_params_from_reference(tree, cfg, CPU)


# ---------------------------------------------------------------- the models
def _rows_close(got, want, tol):
    """Every row (the last axis) within relative L2 ``tol`` of ``want``'s."""
    got = got.float().numpy().reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float32).reshape(got.shape)
    err = np.linalg.norm(got - want, axis=1)
    assert (err <= tol * np.linalg.norm(want, axis=1)).all(), float(err.max())


def _caches_close(got, want, dtype):
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key]), key
        for name in want[key]:
            assert tuple(got[key][name].shape) == want[key][name].shape, (key, name)
            if dtype == "float32":
                _close(got[key][name], want[key][name], F32_TOL)
            else:
                _rows_close(got[key][name], want[key][name], BF16_ROW_TOL)


_jprefill = jax.jit(jlm.prefill, static_argnames=("cfg", "max_seq"))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, cfg = _configs(arch, dtype)
    jparams, params = _carry(jcfg, cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jtoks, ttoks = jnp.asarray(toks), torch.from_numpy(toks).long()
    tol = F32_TOL if dtype == "float32" else BF16_MODEL_TOL
    jlogits, jcache = _jprefill(jparams, jtoks[:, :8], cfg=jcfg, max_seq=12)
    logits, cache = lm.prefill(params, ttoks[:, :8], cfg, max_seq=12)
    assert logits.dtype == TDT[dtype]
    _close(logits, jlogits, tol)
    _caches_close(cache, jcache, dtype)
    for step in range(4):  # teacher-forced: both decode the same tokens
        p = 8 + step
        jlogits, jcache = _jdecode(jparams, jcache, jtoks[:, p:p + 1], p, jcfg)
        logits, cache2 = lm.decode_step(params, cache, ttoks[:, p:p + 1], p, cfg)
        assert cache2 is cache  # written in place
        _close(logits, jlogits, tol)
        _caches_close(cache, jcache, dtype)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["qwen1.5-4b"])
def test_forward_collect_cache_matches_jax(arch):
    jcfg, cfg = _configs(arch, "float32")
    jparams, params = _carry(jcfg, cfg)
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jh, jcache = jax.jit(lambda p, t: jlm.forward(p, t, jcfg, collect_cache=True))(
        jparams, jnp.asarray(toks))
    h, cache = lm.forward(params, torch.from_numpy(toks).long(), cfg, collect_cache=True)
    _close(h, jh, F32_TOL)
    _caches_close(cache, jcache, "float32")
    # without collect_cache: no caches, the same hidden states
    h2, none = lm.forward(params, torch.from_numpy(toks).long(), cfg)
    assert none is None
    _close(h2, h.numpy(), 0.0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_teacher_forced_forward_at_no_drop_capacity(arch):
    """At ``capacity_factor = E / K`` nothing drops, so prefill and decode
    equal one forward over the whole sequence (the JAX package's
    ``tests/test_archs.py`` identity), and ``collect_cache`` gives the
    prefill's and the decode steps' cache rows."""
    jm, m = CONFIGS[arch]
    base = m.smoke_config()
    cfg = dataclasses.replace(base, capacity_factor=base.num_experts / base.top_k)
    params = lm.init(cfg, generator=torch.Generator().manual_seed(1), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab, (2, 12)))
    h, full = lm.forward(params, toks, cfg, collect_cache=True)
    ref = lm.logits_from_hidden(params, h, cfg)
    logits, cache = lm.prefill(params, toks[:, :8], cfg, max_seq=12)
    _close(logits, ref[:, 7].numpy(), F32_TOL)
    for p in range(8, 12):
        logits, cache = lm.decode_step(params, cache, toks[:, p:p + 1], p, cfg)
        _close(logits, ref[:, p].numpy(), F32_TOL)
    for key in full:
        for name in full[key]:
            _close(cache[key][name], full[key][name].numpy(), F32_TOL)


def test_mla_decode_takes_no_kernel():
    """``cfg.attn`` alone picks the decode route: an MLA step attends with
    ``gqa_attention``, and a single-token attention passed for it raises."""
    cfg = deepseek_v2_lite_16b.smoke_config()
    params = lm.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    toks = torch.zeros((1, 4), dtype=torch.long)
    _, cache = lm.prefill(params, toks, cfg, max_seq=5)
    assert set(cache) == {"dense", "moe"} and set(cache["moe"]) == {"ckv", "kr"}
    assert tuple(cache["moe"]["ckv"].shape) == (2, 1, 5, cfg.kv_lora_rank)
    assert tuple(cache["dense"]["kr"].shape) == (1, 1, 5, cfg.rope_head_dim)
    with pytest.raises(ValueError, match="MLA"):
        lm.decode_step(params, cache, toks[:, :1], 4, cfg, attention=decode_attention_ref)
