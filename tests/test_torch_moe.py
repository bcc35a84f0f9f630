"""Port parity for the mixture-of-experts FFN (``nn/moe.py``): ``capacity``,
the routing of ``moe_route``, ``moe_ffn`` and ``init_moe`` against the JAX
package's ``repro.nn.moe``.

Inputs are made with numpy from a seed and go through both packages on the
CPU; weights are the JAX package's ``init_moe`` carried over.  Tolerances,
and why:

* Routing (top-k ids, each assignment's slot, the token in each slot,
  which assignments are kept) is an integer result: equal, in float32
  (the gates, floats, within 1e-5).
* float32 outputs: the same arithmetic in another order: rtol/atol 1e-5.
* bfloat16 outputs: the two frameworks round intermediate bf16 products at
  other places, which moves a result by a bf16 ulp (2^-8 relative): 2e-2.
  A routing pick flipped by such rounding would move an output by far
  more than that, so the bf16 test first asserts that its K-th and
  (K+1)-th logits lie more than one bf16 ulp apart.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from torch_parity import assert_close as _close
from torch_parity import leaves as _leaves

from repro.configs import dbrx_132b as jdbrx
from repro.configs import deepseek_v2_lite_16b as jdeepseek
from repro.nn import moe as jmoe
from repro_torch.configs import dbrx_132b, deepseek_v2_lite_16b
from repro_torch.nn import moe

CPU = "cpu"
F32_TOL = 1e-5
BF16_TOL = 2e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONFIGS = {  # ARCH_ID: (the JAX module, the port's)
    "deepseek-v2-lite-16b": (jdeepseek, deepseek_v2_lite_16b),
    "dbrx-132b": (jdbrx, dbrx_132b),
}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a port tensor of ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(JDT[dtype]),
            torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype]))


_jinit_moe = jax.jit(jmoe.init_moe, static_argnums=(1, 2))


def _moe_pair(E, K, d, f, n_shared, dtype, seed, capacity_factor=1.25):
    """A MoE config in both packages and the JAX package's ``init_moe``
    weights carried into the port (bf16 as bit patterns)."""
    jcfg = jmoe.MoECfg(E, K, d, f, n_shared, capacity_factor)
    cfg = moe.MoECfg(E, K, d, f, n_shared, capacity_factor)
    jp = _jinit_moe(jax.random.PRNGKey(seed), jcfg, JDT[dtype])

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return jcfg, cfg, jp, carry(jp)


# ---------------------------------------------------------------- capacity
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_capacity_matches_jax(arch):
    jm, m = CONFIGS[arch]
    for which in ("smoke_config", "full_config"):
        for factor in (1.0, 1.25, 2.0, 8.0):
            jc = dataclasses.replace(getattr(jm, which)(), capacity_factor=factor).moe_cfg()
            c = dataclasses.replace(getattr(m, which)(), capacity_factor=factor).moe_cfg()
            assert dataclasses.asdict(c) == dataclasses.asdict(jc)
            for T in (1, 2, 7, 8, 13, 64, 100, 512, 4096, 4097, 32768):
                assert moe.capacity(c, T) == jmoe.capacity(jc, T), (which, factor, T)


# ---------------------------------------------------------------- routing
def _jax_route(params, x, cfg):
    """The routing lines of ``repro.nn.moe.moe_ffn`` (``moe.py:56-81``),
    statement for statement, returning what ``moe_route`` returns."""
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = jmoe.capacity(cfg, T)
    logits = (x @ params["router"]).astype(jnp.float32)
    topv, topi = lax.top_k(logits, K)
    gates = jax.nn.softmax(topv, axis=-1).astype(x.dtype)
    flat_e = topi.reshape(-1).astype(jnp.int32)
    flat_t = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = flat_t[order]
    starts = jnp.searchsorted(se, jnp.arange(E, dtype=jnp.int32))
    pos = jnp.arange(T * K, dtype=jnp.int32) - jnp.take(starts, se)
    keep = pos < C
    slot = jnp.where(keep, se * C + pos, E * C)
    token_of_slot = jnp.full(E * C + 1, T, jnp.int32).at[slot].set(st, mode="drop")[: E * C]
    slot_of_flat = jnp.full(T * K, E * C, jnp.int32).at[order].set(jnp.where(keep, slot, E * C))
    return topi, gates, slot_of_flat.reshape(T, K), token_of_slot, slot_of_flat.reshape(T, K) < E * C


_jax_route_jit = jax.jit(_jax_route, static_argnums=(2,))

# (E, K, d, f, n_shared, T, capacity_factor, tie columns)
ROUTE_CASES = {
    "dbrx smoke": (4, 2, 48, 64, 0, 24, 1.25, None),
    "deepseek smoke, drops": (8, 2, 32, 16, 1, 40, 0.5, None),
    "tie of experts 1 and 5": (8, 3, 32, 16, 0, 33, 1.25, (1, 5)),
    "deepseek width": (64, 6, 64, 16, 2, 200, 1.25, None),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_moe_route_matches_jax(case):
    E, K, d, f, n_shared, T, factor, tie = ROUTE_CASES[case]
    jcfg, cfg, jp, tp = _moe_pair(E, K, d, f, n_shared, "float32", 3, factor)
    if tie is not None:   # two equal router columns: every token ties them
        a, b = tie
        jp = {**jp, "router": jp["router"].at[:, b].set(jp["router"][:, a])}
        tp = {**tp, "router": tp["router"].clone()}
        tp["router"][:, b] = tp["router"][:, a]
    x = np.random.default_rng(T).normal(size=(T, d)).astype(np.float32)
    if tie is not None:   # and make the tied pair the winners for the first tokens
        x[:8] = np.asarray(jp["router"])[:, tie[0]] * 40
    want = [np.asarray(a) for a in _jax_route_jit(jp, jnp.asarray(x), jcfg)]
    got = moe.moe_route(tp, torch.from_numpy(x), cfg)
    names = ("topi", "gates", "slot", "token_of_slot", "keep")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        if name == "gates":
            _close(g, w, F32_TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    keep = got.keep.numpy()
    if "drops" in case:
        assert not keep.all()   # the case drops assignments
    if tie is not None:
        a, b = tie
        topi = got.topi.numpy()
        both = (topi == a).any(1) & (topi == b).any(1)
        assert both[:8].all()
        # the lower id first, as lax.top_k
        assert all(list(row).index(a) < list(row).index(b) for row in topi[both])
    # every kept assignment in its expert's rows, the dropped ones nowhere
    C = moe.capacity(cfg, T)
    slots = got.slot.numpy()
    assert ((slots[keep] // C) == got.topi.numpy()[keep]).all()
    assert (got.token_of_slot.numpy()[slots[keep]] == np.nonzero(keep)[0]).all()


# ---------------------------------------------------------------- moe_ffn
def _bf16_logit_gap(jp, x, K):
    """The smallest gap between the K-th and (K+1)-th router logits, over
    the tokens, in units of the K-th logit's bf16 ulp."""
    logits = np.asarray((jnp.asarray(x) @ jp["router"]).astype(jnp.float32))
    s = -np.sort(-logits, axis=-1)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(s[:, K - 1]))) - 7)
    return float(((s[:, K - 1] - s[:, K]) / ulp).min())


def _spread_tokens(router, T, seed):
    """T tokens whose router logits are, token by token, a random
    permutation of E evenly spaced values in [-2, 2]: ``x = L pinv(router)``
    (d > E, so ``x @ router`` gives L back).  Drawn logits of 64 experts
    tie in bfloat16; these lie several bf16 ulps apart."""
    rng = np.random.default_rng(seed)
    E = router.shape[1]
    L = np.stack([rng.permutation(np.linspace(-2.0, 2.0, E)) for _ in range(T)])
    return (L @ np.linalg.pinv(np.asarray(router, np.float64))).astype(np.float32)


# (E, K, d, f, n_shared, T)
FFN_CASES = {
    "dbrx smoke": (4, 2, 48, 64, 0, 16),
    "deepseek smoke": (8, 2, 32, 16, 1, 16),
    "64 experts, 2 shared": (64, 6, 128, 16, 2, 48),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case, dtype):
    E, K, d, f, n_shared, T = FFN_CASES[case]
    jcfg, cfg, jp, tp = _moe_pair(E, K, d, f, n_shared, dtype, 5)
    x = _spread_tokens(np.asarray(jp["router"], np.float32), T, E + T)
    jx, tx = _pair(x, dtype)
    if dtype == "bfloat16":
        assert _bf16_logit_gap(jp, jx, K) > 1.0
    want = jax.jit(jmoe.moe_ffn, static_argnums=(2,))(jp, jx, jcfg)
    got = moe.moe_ffn(tp, tx, cfg)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (T, d)
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_moe_ffn_is_a_loop_over_experts():
    """``moe_ffn`` against an independent loop: each expert takes its first
    C assignments in t·K + k order, the gates are not renormalised."""
    E, K, d, f, T = 8, 2, 32, 16, 40
    _, cfg, _, tp = _moe_pair(E, K, d, f, 1, "float32", 7, capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(T, d)).astype(np.float32))
    C = moe.capacity(cfg, T)
    logits = (x @ tp["router"]).double()
    want = torch.zeros(T, d, dtype=torch.float64)
    taken = [0] * E
    dropped = 0
    for t in range(T):
        top = sorted(range(E), key=lambda e: (-float(logits[t, e]), e))[:K]
        gates = torch.softmax(logits[t, top], dim=0)
        for k, e in enumerate(top):
            if taken[e] == C:
                dropped += 1
                continue
            taken[e] += 1
            h = torch.nn.functional.silu(x[t].double() @ tp["w_gate"][e].double())
            h = h * (x[t].double() @ tp["w_up"][e].double())
            want[t] += gates[k] * (h @ tp["w_down"][e].double())
    sh = tp["shared"]
    want += (torch.nn.functional.silu(x.double() @ sh["w_gate"].double())
             * (x.double() @ sh["w_up"].double())) @ sh["w_down"].double()
    assert dropped > 0
    assert int((~moe.moe_route(tp, x, cfg).keep).sum()) == dropped
    _close(moe.moe_ffn(tp, x, cfg), want.numpy(), F32_TOL)


def test_init_moe_shapes_and_scales():
    cfg = moe.MoECfg(8, 2, 64, 32, n_shared=2)
    own = moe.init_moe(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                       device=CPU)
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0),
                                                jmoe.MoECfg(8, 2, 64, 32, n_shared=2),
                                                jnp.bfloat16))
    got, ref = _leaves(own), _leaves(want)
    assert set(got) == set(ref)
    for name, t in got.items():
        assert tuple(t.shape) == ref[name].shape and t.dtype == torch.bfloat16, name
        fan_in = t.shape[-2]
        assert abs(float(t.float().std()) * fan_in ** 0.5 - 1.0) < 0.1, name
