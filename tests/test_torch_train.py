"""Port parity for the training path: ``optim/`` (schedule, int8
compression, clipping, AdamW), ``moe_aux_loss``, the LM and SASRec
``loss_fn`` and their gradients, remat in a training forward, and the
``Trainer`` (in ``test_torch_trainer.py``).

Inputs are made with numpy from a seed and go through both packages on the
CPU; JAX's parameters cross with ``lm_params_from_reference`` /
``sasrec_params_from_reference``.  Tolerances, and why:

* ``quantize_int8`` / ``dequantize_int8``, and AdamW's moments given the
  same gradients: exact against JAX op by op (the same float32 operations
  in the same order; under ``jit`` XLA fuses multiply-adds, one ulp away).
* ``clip_by_global_norm``: the norm within rtol 1e-6 and the clipped
  gradients within 2e-6 (float32) or one bf16 ulp: the sum of squares over
  all leaves is taken in another order.
* ``warmup_cosine`` against JAX op by op: within one float32 ulp, equal in
  the warm-up and at the ends: XLA's float32 cosine and the rounded
  float64 one the port takes differ in the last place at a few arguments.
* AdamW's parameters: rtol 1e-6 in float32 (the bias corrections ``b**t``
  come from two libraries' ``pow``), one bf16 ulp in bfloat16.
* ``moe_aux_loss``: rtol 1e-6 (softmax and means summed in another order).
* ``loss_fn``: the value within rtol 1e-6, each gradient leaf within
  relative L2 1e-5 (float32 through a few layers, summed in other orders;
  measured 1.4e-6 at most).  A MoE config's tokens are checked to route
  apart: every token's K-th and (K+1)-th router logits at least
  ``ROUTE_GAP`` apart at every MoE layer, so no rounding flips a pick.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import leaves as _leaves
from torch_parity import numpy_tree as _numpy_tree

from repro import optim as joptim
from repro.configs import dbrx_132b as jdbrx
from repro.configs import deepseek_v2_lite_16b as jdeepseek
from repro.configs import qwen2_1_5b as jqwen
from repro.configs import sasrec as jsasrec_config
from repro.models import sasrec as jsasrec
from repro.models import transformer_lm as jlm
from repro.nn.moe import moe_aux_loss as jmoe_aux_loss
from repro_torch import optim
from repro_torch.configs import dbrx_132b, deepseek_v2_lite_16b, qwen2_1_5b
from repro_torch.configs import sasrec as sasrec_config
from repro_torch.core.convert import lm_params_from_reference, sasrec_params_from_reference
from repro_torch.launch import value_and_grad
from repro_torch.models import sasrec
from repro_torch.models import transformer_lm as lm
from repro_torch.nn import moe as port_moe
from repro_torch.nn import moe_aux_loss

CPU = "cpu"
REL = 1e-6
GRAD_REL_L2 = 1e-5
ROUTE_GAP = 1e-3
LM_ARCHS = {"qwen2-1.5b": (jqwen, qwen2_1_5b), "deepseek-v2-lite-16b": (jdeepseek,
                                                                        deepseek_v2_lite_16b),
            "dbrx-132b": (jdbrx, dbrx_132b)}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ulps(got, want):
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _tree_leaves(tree, prefix=""):
    """Leaves of a dict / list tree as ``{"/a/0/b": leaf}``."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _tree_leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _tree_leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _np_tree(tree):
    """A JAX tree (dicts and lists) as numpy; bf16 as uint16 bit patterns."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return _numpy_tree(tree)


# ---------------------------------------------------------------- optim
@pytest.mark.parametrize("warmup,total,floor", [(100, 10_000, 0.1), (20, 100, 0.1), (3, 7, 0.0),
                                                (0, 50, 0.2), (5, 1000, 0.1)])
def test_warmup_cosine_matches_jax(warmup, total, floor):
    steps = list(range(0, 1100, 1)) + [9_999, 10_000, 12_000]
    # JAX op by op, as the function is written (under jit XLA fuses the
    # cosine's affine map, and its value moves a few ulps more)
    jfn = lambda s: joptim.warmup_cosine(s, warmup=warmup, total=total, floor=floor)  # noqa: E731
    want = np.stack([np.asarray(jfn(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.stack([optim.warmup_cosine(torch.tensor(s, dtype=torch.int32), warmup=warmup,
                                        total=total, floor=floor).numpy() for s in steps])
    assert got.dtype == np.float32
    assert int(_ulps(got, want).max()) <= 1
    ends = np.array([s <= warmup or s >= total for s in steps])
    assert np.array_equal(got[ends], want[ends])


def test_int8_compression_matches_jax():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal((64, 33)).astype(np.float32) * 3,
             np.zeros((5,), np.float32),
             np.asarray([0.5, -0.5, 1.5, 2.5, -127.4, 127.6], np.float32)]
    for x in cases:
        jq, js = joptim.quantize_int8(jnp.asarray(x))
        q, s = optim.quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().view(np.int32) == np.asarray(js).view(np.int32)
        for jdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jax.jit(joptim.dequantize_int8, static_argnums=2)(jq, js, jdt)
                              .astype(jnp.float32))
            assert np.array_equal(optim.dequantize_int8(q, s, dt).float().numpy(), want)
    tree = {"a": torch.from_numpy(cases[0]), "b": [torch.from_numpy(cases[2])]}
    back = optim.decompress_tree(optim.compress_tree(tree))
    assert set(back) == {"a", "b"} and isinstance(back["b"], list)
    jback = jax.tree.map(lambda qs: joptim.dequantize_int8(*joptim.quantize_int8(qs)),
                         jnp.asarray(cases[0]))
    assert np.array_equal(back["a"].numpy(), np.asarray(jback))


def _opt_case(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (12, 7), "blocks": [(5,), (3, 4)], "b": (9,)}
    def draw(scale):
        return {"w": rng.standard_normal(shapes["w"]).astype(np.float32) * scale,
                "blocks": [rng.standard_normal(s).astype(np.float32) * scale
                           for s in shapes["blocks"]],
                "b": rng.standard_normal(shapes["b"]).astype(np.float32) * scale}
    p, g1, g2 = draw(1.0), draw(0.3), draw(1e-3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jt = lambda t: jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), t)  # noqa: E731
    tt = lambda t: optim.tree_map(lambda a: torch.from_numpy(a).to(tdt), t)  # noqa: E731
    return (jt(p), [jt(g1), jt(g2)]), (tt(p), [tt(g1), tt(g2)])


def _to_port(jtree, dtype):
    return optim.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype),
                          jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_and_adamw_update_match_jax(dtype):
    """``clip_by_global_norm`` (a norm over 1 and one under), then three
    AdamW updates with an ``lr_scale`` tensor, both packages given JAX's
    clipped gradients."""
    (jp, jgs), (tp, tgs) = _opt_case(1, dtype)
    tdt = getattr(torch, dtype)
    cfg, jcfg = optim.AdamWConfig(weight_decay=0.05), joptim.AdamWConfig(weight_decay=0.05)
    js, ts = joptim.adamw_init(jp), optim.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for i in range(3):
        jg, jgn = joptim.clip_by_global_norm(jgs[i % 2], 1.0)
        tg, tgn = optim.clip_by_global_norm(tgs[i % 2], 1.0)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=REL)
        assert (float(tgn) > 1.0) == (i % 2 == 0)
        for k, leaf in _tree_leaves(tg).items():
            want = np.asarray(_tree_leaves(jg)[k].astype(jnp.float32))
            assert leaf.dtype == tdt
            if dtype == "float32":
                np.testing.assert_allclose(leaf.numpy(), want, rtol=2 * REL, atol=0, err_msg=k)
            else:
                assert int(np.abs(leaf.view(torch.int16).numpy().astype(np.int64) - np.asarray(
                    _tree_leaves(jg)[k]).view(np.int16).astype(np.int64)).max()) <= 1, k
        jp, js = joptim.adamw_update(jp, jg, js, jcfg, jnp.float32(0.7))  # op by op
        tp, ts = optim.adamw_update(tp, _to_port(jg, tdt), ts, cfg, lr_scale=torch.tensor(0.7))
    assert int(ts["step"]) == int(js["step"]) == 3
    for name in ("m", "v"):
        for k, leaf in _tree_leaves(ts[name]).items():
            assert leaf.dtype == torch.float32
            assert np.array_equal(leaf.numpy(), np.asarray(_tree_leaves(js[name])[k])), name + k
    for k, leaf in _tree_leaves(tp).items():
        assert leaf.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(leaf.numpy(), np.asarray(_tree_leaves(jp)[k]), rtol=REL,
                                       atol=0, err_msg=k)
        else:
            got16 = leaf.view(torch.int16).numpy().astype(np.int64)
            want16 = np.asarray(_tree_leaves(jp)[k]).view(np.int16).astype(np.int64)
            assert int(np.abs(got16 - want16).max()) <= 1, k


def test_moe_aux_loss_matches_jax():
    rng = np.random.default_rng(2)
    for T, E, K in ((64, 8, 2), (33, 16, 4)):
        logits = rng.standard_normal((T, E)).astype(np.float32) * 2
        topi = np.argsort(-logits, axis=-1, kind="stable")[:, :K].astype(np.int32)
        want = float(jmoe_aux_loss(jnp.asarray(logits), jnp.asarray(topi), E))
        got = moe_aux_loss(torch.from_numpy(logits), torch.from_numpy(topi), E)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=REL)


# ---------------------------------------------------------------- losses
_jinit = jax.jit(jlm.init, static_argnums=(1,))
_jlm_value_and_grad = jax.jit(jax.value_and_grad(jlm.loss_fn), static_argnums=(2,))


def _lm_case(arch, seed=1, B=2, S=24, dtype="float32"):
    jm, m = LM_ARCHS[arch]
    jcfg = dataclasses.replace(jm.smoke_config(), dtype=dtype)
    cfg = dataclasses.replace(m.smoke_config(), dtype=dtype)
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_reference(_numpy_tree(jparams), cfg, CPU)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tgt[0, :3] = -1  # masked positions
    return jcfg, cfg, jparams, params, toks, tgt


def _route_gaps(monkeypatch):
    """Record, at every MoE call, the smallest gap between a token's K-th and
    (K+1)-th router logits."""
    gaps = []
    route = port_moe.moe_route

    def logged(params, x, cfg):
        logits = (x @ params["router"]).float()
        top = torch.sort(logits, dim=-1, descending=True).values
        gaps.append(float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min()))
        return route(params, x, cfg)

    monkeypatch.setattr(port_moe, "moe_route", logged)
    return gaps


@pytest.mark.parametrize("arch", list(LM_ARCHS))
def test_lm_loss_and_grads_match_jax(arch, monkeypatch):
    jcfg, cfg, jparams, params, toks, tgt = _lm_case(arch)
    gaps = _route_gaps(monkeypatch)
    jl, jg = _jlm_value_and_grad(jparams, {"tokens": jnp.asarray(toks),
                                           "targets": jnp.asarray(tgt)}, jcfg)
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt)}
    l, g = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg), params)
    if cfg.moe:
        assert gaps and min(gaps) > ROUTE_GAP, gaps
    assert l.dtype == torch.float32 and l.shape == ()
    np.testing.assert_allclose(float(l), float(jl), rtol=REL)
    want, got = _leaves(_numpy_tree(jg)), _leaves(g)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert _rel_l2(got[k], want[k]) <= GRAD_REL_L2, (k, _rel_l2(got[k], want[k]))


def test_lm_loss_masks_negative_targets():
    _, cfg, _, params, toks, tgt = _lm_case("qwen2-1.5b")
    t = torch.from_numpy(toks)
    with torch.no_grad():
        full = lm.loss_fn(params, {"tokens": t, "targets": torch.from_numpy(tgt)}, cfg)
        tgt2 = tgt.copy()
        tgt2[0, :3] = -7  # another negative: the same mask
        again = lm.loss_fn(params, {"tokens": t, "targets": torch.from_numpy(tgt2)}, cfg)
        none = lm.loss_fn(params, {"tokens": t, "targets": torch.full_like(t, -1)}, cfg)
    assert torch.equal(full, again) and float(none) == 0.0


def _sasrec_case(padded):
    jcfg, cfg = jsasrec_config.smoke_config(), sasrec_config.smoke_config()
    jparams = jsasrec.init(jax.random.PRNGKey(0), jcfg)
    params = sasrec_params_from_reference(_np_tree(jparams), cfg, CPU)
    batch = {k: np.array(v) for k, v in jsasrec_config.smoke_batch(0).items() if k != "candidates"}
    if padded:  # zero-padded prefixes of 0..5 positions, as make_sasrec_batch_fn makes
        for r, cut in enumerate((0, 2, 5, 3)):
            for k in batch:
                batch[k][r, :cut] = 0
    return jcfg, cfg, jparams, params, batch


_jsas_value_and_grad = jax.jit(jax.value_and_grad(jsasrec.loss_fn), static_argnums=(2,))


@pytest.mark.parametrize("padded", [False, True])
def test_sasrec_loss_and_grads_match_jax(padded):
    """Every item lookup (seq, pos, neg) through ``take_rows``, so the item
    table's gradient through kernel 5's plain backward."""
    jcfg, cfg, jparams, params, batch = _sasrec_case(padded)
    jl, jg = _jsas_value_and_grad(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    l, g = value_and_grad(lambda p: sasrec.loss_fn(p, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()}, cfg), params)
    np.testing.assert_allclose(float(l), float(jl), rtol=REL)
    want, got = _tree_leaves(_np_tree(jg)), _tree_leaves(g)
    assert set(got) == set(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= GRAD_REL_L2, (k, _rel_l2(got[k], want[k]))
    touched = np.unique(np.concatenate([batch[k].reshape(-1) for k in batch]))
    rows = np.abs(got["/item_emb"].numpy()).sum(1) > 0
    assert set(np.flatnonzero(rows)) <= set(touched)


# ---------------------------------------------------------------- remat
class _CountProducts(TorchDispatchMode):
    """Counts the unbatched products run (forward, recompute and backward)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-lite-16b"])
def test_remat_policies_give_equal_grads(arch, monkeypatch):
    """"full", "dots" and no remat at all (each layer's ``_block`` called
    directly) give the same gradients bit for bit; a training forward
    recomputes every layer under "full" and "dots" (two ``_block`` calls a
    layer), "dots" recomputes no unbatched product, and serving
    (``no_grad``) runs no checkpoint."""
    _, cfg0, _, params, toks, tgt = _lm_case(arch)
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt)}
    calls = [0]
    block = lm._block

    def counted(*args, **kwargs):
        calls[0] += 1
        return block(*args, **kwargs)

    monkeypatch.setattr(lm, "_block", counted)
    remat_block = lm._remat_block
    grads, products, blocks = {}, {}, {}
    for policy in ("full", "dots", "none"):
        cfg = dataclasses.replace(cfg0, remat_policy="full" if policy == "none" else policy)
        monkeypatch.setattr(lm, "_remat_block",
                            (lambda p, x, c, pos, moe: counted(p, x, c, pos, moe))
                            if policy == "none" else remat_block)
        calls[0] = 0
        with _CountProducts() as mode:
            _, grads[policy] = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg), params)
        products[policy], blocks[policy] = mode.n, calls[0]
    for policy in ("dots", "none"):
        for k, v in _leaves(grads["full"]).items():
            assert torch.equal(_leaves(grads[policy])[k], v), (policy, k)
    assert blocks["full"] == blocks["dots"] == 2 * cfg0.n_layers
    assert blocks["none"] == cfg0.n_layers
    assert products["full"] > products["dots"] == products["none"], products
    monkeypatch.setattr(lm, "_remat_block", remat_block)
    calls[0] = 0
    with torch.no_grad():
        lm.loss_fn(params, batch, cfg0)
    assert calls[0] == cfg0.n_layers
