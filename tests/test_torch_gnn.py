"""Port parity for the GNN family's aggregation layer, ``nn/mlp.py``'s
``mlp2``, GIN, PNA, the neighbour sampler and the GNN cells.

The same numpy inputs go through the JAX package and the port on the CPU;
JAX's parameters cross with ``gnn_params_from_reference``; JAX's value and
gradient come from one ``jax.value_and_grad`` per case.  Tolerances, and
why:

* Gathers, max and min (values and gradients, ties split evenly among the
  tied elements), degrees, the sampler, the smoke batches and the cells:
  exact.  Max and min pick an element; degrees add ones.
* Sums, means, std and the edge softmax: float32 within 1e-6 (relative
  1e-5): the two libraries add in other orders.
* Losses within relative 1e-5 and every gradient leaf within relative L2
  1e-4 of JAX's, or within 1e-7 of the whole gradient's norm where a leaf's
  gradient vanishes analytically; observed up to ~4e-6, float32 products
  and sums in other orders through 2-5 layers.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from gnn_parity import flat, hold_loss_and_grads, numpy_tree

from repro.configs import gin_tu as jgin_config
from repro.configs import gnn_common as jgnn_common
from repro.configs import pna as jpna_config
from repro.data import neighbor_sampler as jsampler
from repro.models.gnn import aggregate as jagg
from repro.nn import mlp as jmlp
from repro_torch import optim
from repro_torch.configs import GNN_ARCHS, gin_tu, gnn_common, pna
from repro_torch.core.convert import gnn_params_from_reference
from repro_torch.data import padded_sizes, sample_fanout
from repro_torch.launch import TrainConfig, Trainer
from repro_torch.models.gnn import aggregate as agg
from repro_torch.nn.mlp import init_mlp2, mlp2

CPU = "cpu"
SUM_ATOL = 1e-6
SUM_RTOL = 1e-5


# ----------------------------------------------------------------------
# aggregation primitives
# ----------------------------------------------------------------------
N = 9


def _edges(seed, E=40, d=3):
    """Values (E, d) and destinations in [0, N] with duplicates, the
    sentinel N, empty segments (7 and 8 receive nothing) and ties."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 7, E).astype(np.int32)
    dst[:4] = N                      # the sentinel: dropped
    dst[dst == 3] = 4
    dst[4:8] = 3                     # a segment of four edges
    vals = rng.integers(-3, 4, (E, d)).astype(np.float32)  # small integers: exact ties
    vals[4:8, 0] = 2.0               # one column tied four ways in segment 3
    return vals, dst


@pytest.mark.parametrize("fill", [0.0, -2.5])
def test_gather_src_is_take_fill(fill):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, 4)).astype(np.float32)
    ids = np.array([0, 3, N - 1, N, N + 3, -1, -N, -N - 1, 2 ** 20, 5], np.int32)
    want = np.asarray(jagg.gather_src(jnp.asarray(x), jnp.asarray(ids), fill))
    got = agg.gather_src(torch.from_numpy(x), torch.from_numpy(ids), fill).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["scatter_sum", "scatter_mean", "scatter_max", "scatter_min",
                                  "scatter_std"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_matches_jax_value_and_gradient(name, seed):
    """Forward and the vjp of a random cotangent; max and min bit for bit,
    their empty segments exactly -1e30 / 1e30."""
    vals, dst = _edges(seed)
    cot = np.random.default_rng(seed + 10).normal(size=(N, vals.shape[1])).astype(np.float32)
    jfn = getattr(jagg, name)
    want, vjp = jax.vjp(lambda v: jfn(v, jnp.asarray(dst), N), jnp.asarray(vals))
    (want_g,) = vjp(jnp.asarray(cot))
    v = torch.from_numpy(vals).requires_grad_(True)
    got = getattr(agg, name)(v, torch.from_numpy(dst), N)
    (got_g,) = torch.autograd.grad(got, v, torch.from_numpy(cot))
    want, want_g = np.asarray(want), np.asarray(want_g)
    if name in ("scatter_max", "scatter_min"):
        np.testing.assert_array_equal(got.detach().numpy(), want)
        np.testing.assert_array_equal(got_g.numpy(), want_g)
        empty = {"scatter_max": np.float32(-1e30), "scatter_min": np.float32(1e30)}[name]
        assert np.all(got.detach().numpy()[7:] == empty)
        # the four tied maxima of segment 3's first column share its cotangent
        tied = got_g.numpy()[4:8, 0]
        if name == "scatter_max":
            assert np.all(tied == np.float32(cot[3, 0] / 4))
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=SUM_RTOL, atol=SUM_ATOL)
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=SUM_RTOL, atol=SUM_ATOL)


def test_scatter_mean_and_std_with_given_degrees():
    vals, dst = _edges(2)
    deg = np.asarray(jagg.degrees(jnp.asarray(np.minimum(dst, N)), N))
    pdeg = agg.degrees(torch.from_numpy(np.minimum(dst, N)), N)
    np.testing.assert_array_equal(pdeg.numpy(), deg)
    for name in ("scatter_mean", "scatter_std"):
        want = getattr(jagg, name)(jnp.asarray(vals), jnp.asarray(dst), N, deg=jnp.asarray(deg))
        got = getattr(agg, name)(torch.from_numpy(vals), torch.from_numpy(dst), N, deg=pdeg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SUM_RTOL, atol=SUM_ATOL)


def test_segment_ids_outside_the_range_are_dropped():
    """JAX's segment ops drop ids < 0 and > n; so does the port."""
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    dst = np.array([0, -1, N + 5, 2, N, 2], np.int32)
    for name in ("scatter_sum", "scatter_max", "scatter_min"):
        want = getattr(jagg, name)(jnp.asarray(vals), jnp.asarray(dst), N)
        got = getattr(agg, name)(torch.from_numpy(vals), torch.from_numpy(dst), N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_softmax_matches_jax(seed):
    """Edge softmax by destination, with the sentinel and -1e30 logits of
    invalid edges; its gradient through the detached max."""
    rng = np.random.default_rng(seed)
    E, H = 30, 2
    dst = rng.integers(0, N, E).astype(np.int32)
    dst[:3] = N
    dst[dst == N - 1] = 0            # the last node receives a real edge below
    dst[3] = N - 1
    scores = rng.normal(size=(E, H)).astype(np.float32)
    scores[:3] = -1e30
    cot = rng.normal(size=(E, H)).astype(np.float32)
    want, vjp = jax.vjp(lambda s: jagg.segment_softmax(s, jnp.asarray(dst), N),
                        jnp.asarray(scores))
    (want_g,) = vjp(jnp.asarray(cot))
    s = torch.from_numpy(scores).requires_grad_(True)
    got = agg.segment_softmax(s, torch.from_numpy(dst), N)
    (got_g,) = torch.autograd.grad(got, s, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=SUM_RTOL, atol=SUM_ATOL)


# ----------------------------------------------------------------------
# mlp2
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bias", [True, False])
def test_mlp2_matches_jax_with_tanh_gelu(bias):
    """``jax.nn.gelu`` is the tanh form by default; the port's ``mlp2``
    uses it (the exact erf form would miss by ~1e-4)."""
    jp = jmlp.init_mlp2(jax.random.PRNGKey(3), 5, 7, 4, bias=bias)
    x = np.random.default_rng(3).normal(size=(6, 5)).astype(np.float32) * 3
    want, vjp = jax.vjp(lambda p: jmlp.mlp2(p, jnp.asarray(x)), jp)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    got = mlp2(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    cot = np.ones(want.shape, np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    pg = torch.autograd.grad(got, list(params.values()), torch.from_numpy(cot))
    for (k, _), g in zip(params.items(), pg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-5, atol=1e-5)
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ params["w1"].detach())
    tanh = torch.nn.functional.gelu(torch.from_numpy(x) @ params["w1"].detach(), approximate="tanh")
    assert float((erf - tanh).abs().max()) > 1e-5


def test_init_mlp2_shapes_and_zero_biases():
    p = init_mlp2(5, 7, 4, generator=torch.Generator().manual_seed(0), device=CPU)
    jp = jmlp.init_mlp2(jax.random.PRNGKey(0), 5, 7, 4)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    assert not p["b1"].any() and not p["b2"].any()
    assert set(init_mlp2(5, 7, 4, generator=torch.Generator(), bias=False, device=CPU)) == {
        "w1", "w2"}


# ----------------------------------------------------------------------
# GIN and PNA
# ----------------------------------------------------------------------
def _node_task(cfg, n_classes=8):
    return dataclasses.replace(cfg, task="node", n_classes=n_classes)


@pytest.mark.parametrize("variant", ["smoke", "node"])
def test_gin_loss_and_gradients_match_jax(variant):
    """The smoke config (graph regression) and a node-classification
    variant whose labels include -1 (masked out)."""
    jcfg, pcfg = jgin_config.smoke_config(), gin_tu.smoke_config()
    if variant == "smoke":
        batch = gin_tu.smoke_batch(0, device=CPU)
    else:
        jcfg, pcfg = _node_task(jcfg), _node_task(pcfg)
        batch = gnn_common.gnn_smoke_batch(1, task="node", n_classes=8, device=CPU)
        batch["labels"][::5] = -1
    g = hold_loss_and_grads(jgin_config.MODULE, jcfg, gin_tu.MODULE, pcfg, batch)
    assert all(float(x.abs().sum()) > 0 for x in optim.tree_leaves(g["layers"]))


def _ties_batch():
    """PNA's smoke batch with every edge into node 5 doubled (exact ties in
    max and min), node 0 isolated (its in-edges re-pointed), and 4 sentinel
    edges."""
    b = pna.smoke_batch(0, device=CPU)
    src, dst = b["edge_src"].clone(), b["edge_dst"].clone()
    n = b["node_feat"].shape[0]
    dst[dst == 0] = 1
    into5 = dst == 5
    assert int(into5.sum()) >= 2
    src = torch.cat([src, src[into5], torch.full((4,), n, dtype=torch.int32)])
    dst = torch.cat([dst, dst[into5], torch.full((4,), n, dtype=torch.int32)])
    return dict(b, edge_src=src, edge_dst=dst)


@pytest.mark.parametrize("variant", ["smoke", "ties", "graph"])
def test_pna_loss_and_gradients_match_jax(variant):
    """The smoke config (node classification); duplicate edges, an isolated
    node and sentinel edges; and the graph-regression task."""
    jcfg, pcfg = jpna_config.smoke_config(), pna.smoke_config()
    if variant == "smoke":
        batch = pna.smoke_batch(0, device=CPU)
    elif variant == "ties":
        batch = _ties_batch()
    else:
        jcfg = dataclasses.replace(jcfg, task="graph", n_classes=1, n_graphs=4)
        pcfg = dataclasses.replace(pcfg, task="graph", n_classes=1, n_graphs=4)
        batch = gin_tu.smoke_batch(2, device=CPU)
    hold_loss_and_grads(jpna_config.MODULE, jcfg, pna.MODULE, pcfg, batch)


def test_pna_isolated_node_gets_zero_aggregates():
    """Node 0 of the ties batch has no in-edge: its output equals the
    update of its own state alone (every aggregate 0), in both packages."""
    batch = _ties_batch()
    cfg = pna.smoke_config()
    params = pna.MODULE.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    out = pna.MODULE.forward(params, batch, cfg)
    moved = dict(batch, node_feat=batch["node_feat"].clone())
    moved["node_feat"][1:] += 1.0     # every other node changes
    again = pna.MODULE.forward(params, moved, cfg)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], again[0])


# ----------------------------------------------------------------------
# the sampler
# ----------------------------------------------------------------------
def _csr(n, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 25, n)
    deg[::7] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    return offsets, rng.integers(0, n, int(offsets[-1]))


@pytest.mark.parametrize("fanouts", [(3, 2), (15, 10), (5,), (2, 2, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_fanout_equals_jax(fanouts, seed):
    offsets, targets = _csr(400, seed)
    seeds = np.random.default_rng(seed + 5).choice(400, 16, replace=False)
    want = jsampler.sample_fanout(offsets, targets, seeds, fanouts,
                                  rng=np.random.default_rng(seed))
    got = sample_fanout(offsets, targets, seeds, fanouts, rng=np.random.default_rng(seed))
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]
    assert got[0][got[3]:].tolist() == [-1] * (len(got[0]) - got[3])


def test_padded_sizes_equal_jax():
    for n, f in [(1024, (15, 10)), (8, (3, 2)), (3, ()), (5, (1, 1, 4))]:
        assert padded_sizes(n, f) == jsampler.padded_sizes(n, f)
    assert padded_sizes(1024, (15, 10)) == (169_984, 168_960)


# ----------------------------------------------------------------------
# cells and smoke batches
# ----------------------------------------------------------------------
def _jax_config_module(arch):
    from repro.configs import get_arch

    return get_arch(arch)


@pytest.mark.parametrize("arch", sorted(GNN_ARCHS))
def test_cells_equal_jax(arch):
    """Every cell: shapes, dtypes, logical names, rules, the model config
    field for field and ``model_flops``."""
    mine, ref = GNN_ARCHS[arch].cells(), _jax_config_module(arch).cells()
    assert list(mine) == list(ref)
    for shape, c in mine.items():
        r = ref[shape]
        assert (c.arch, c.shape, c.kind, c.family, c.notes) == (r.arch, r.shape, r.kind,
                                                                r.family, r.notes)
        assert dataclasses.asdict(c.model_cfg) == dataclasses.asdict(r.model_cfg)
        assert type(c.model_cfg).__name__ == type(r.model_cfg).__name__
        assert c.model_flops == r.model_flops
        assert c.rules == r.rules and c.batch_logical == r.batch_logical
        assert list(c.batch_specs) == list(r.batch_specs)
        for k, s in c.batch_specs.items():
            assert s.shape == r.batch_specs[k].shape, (shape, k)
            assert str(s.dtype).removeprefix("torch.") == str(r.batch_specs[k].dtype), (shape, k)


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"])
def test_gnn_shape_dims_equal_jax(shape):
    assert gnn_common.gnn_shape_dims(shape) == jgnn_common.gnn_shape_dims(shape)


@pytest.mark.parametrize("arch", sorted(GNN_ARCHS))
@pytest.mark.parametrize("seed", [0, 3])
def test_smoke_batch_equals_jax(arch, seed):
    mine = GNN_ARCHS[arch].smoke_batch(seed, device=CPU)
    ref = _jax_config_module(arch).smoke_batch(seed)
    assert list(mine) == list(ref)
    for k, v in mine.items():
        w = np.asarray(ref[k])
        assert v.numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(v.numpy(), w)


@pytest.mark.parametrize("arch", sorted(GNN_ARCHS))
def test_init_tree_has_jax_leaves(arch):
    """``init`` (full and smoke configs) gives JAX's leaves and shapes;
    biases and GIN's eps start at 0; ``param_specs`` equals JAX's."""
    m, jm = GNN_ARCHS[arch], _jax_config_module(arch)
    for cfg in (m.smoke_config(), m.full_config()):
        params = m.MODULE.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
        shapes = jax.eval_shape(lambda: jm.MODULE.init(jax.random.PRNGKey(0), cfg))
        fj, fp = flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)), flat(params)
        assert {k: v.shape for k, v in fp.items()} == {k: v.shape for k, v in fj.items()}
        for k, v in fp.items():
            assert v.dtype == np.float32
            if k.endswith(("/b1", "/b2", "/eps")):
                assert not v.any(), k
        assert m.MODULE.param_specs(cfg) == jm.MODULE.param_specs(cfg)


def test_converter_refuses_wrong_trees():
    cfg = gin_tu.smoke_config()
    tree = numpy_tree(jgin_config.MODULE.init(jax.random.PRNGKey(0), cfg))
    params = gnn_params_from_reference(tree, cfg, device=CPU)
    assert params["layers"][0]["eps"].shape == ()
    with pytest.raises(ValueError, match="leaves"):
        gnn_params_from_reference({k: v for k, v in tree.items() if k != "head"}, cfg,
                                  device=CPU)
    with pytest.raises(ValueError, match="layers"):
        gnn_params_from_reference({**tree, "layers": tree["layers"][:1]}, cfg, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        bad = {**tree, "layers": [dict(tree["layers"][0], eps=np.zeros(1, np.float32)),
                                  tree["layers"][1]]}
        gnn_params_from_reference(bad, cfg, device=CPU)
    with pytest.raises(TypeError, match="float32"):
        gnn_params_from_reference({**tree, "head": {k: v.astype(np.float64)
                                                    for k, v in tree["head"].items()}},
                                  cfg, device=CPU)
    with pytest.raises(TypeError, match="not a GNN config"):
        gnn_params_from_reference(tree, object(), device=CPU)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def test_gin_trainer_restart_is_bit_identical(tmp_path):
    """3 GIN steps with a checkpoint every step, against a run that fails
    at step 2 and resumes: parameters (the 0-d eps leaves too) and AdamW
    state bit for bit; every loss finite."""
    cfg = gin_tu.smoke_config()

    def make(step):
        return gin_tu.smoke_batch(step, device=CPU)

    tc = dict(steps=3, ckpt_every=1, warmup=1, log_every=1)
    p_clean, o_clean, h_clean = Trainer(gin_tu.MODULE, cfg, train_cfg=TrainConfig(**tc),
                                        device=CPU).fit(make, ckpt_dir=str(tmp_path / "clean"))
    failing = Trainer(gin_tu.MODULE, cfg, train_cfg=TrainConfig(**tc, fail_at_step=2),
                      device=CPU)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        failing.fit(make, ckpt_dir=str(tmp_path / "crash"))
    p, o, h = Trainer(gin_tu.MODULE, cfg, train_cfg=TrainConfig(**tc),
                      device=CPU).fit(make, ckpt_dir=str(tmp_path / "crash"))
    assert [x["step"] for x in h] == [3]
    assert h[0]["loss"] == h_clean[2]["loss"]
    assert all(np.isfinite(x["loss"]) for x in h_clean)
    assert p["layers"][0]["eps"].shape == () and float(p["layers"][0]["eps"]) != 0.0
    for a, b in zip(optim.tree_leaves({"p": p, "o": o}),
                    optim.tree_leaves({"p": p_clean, "o": o_clean})):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"])
@pytest.mark.parametrize("with_pos,with_triplets,n_graphs", [(False, False, None),
                                                             (True, True, 128), (True, False, 4)])
def test_gnn_graph_specs_equal_jax(shape, with_pos, with_triplets, n_graphs):
    from repro.configs import common as jcommon
    from repro_torch.configs import common

    mine = common.gnn_graph_specs(shape, with_pos=with_pos, with_triplets=with_triplets,
                                  n_graphs=n_graphs)
    ref = jcommon.gnn_graph_specs(shape, with_pos=with_pos, with_triplets=with_triplets,
                                  n_graphs=n_graphs)
    assert mine[1:] == ref[1:]
    assert {k: (s.shape, str(s.dtype).removeprefix("torch.")) for k, s in mine[0].items()} == {
        k: (s.shape, str(s.dtype)) for k, s in ref[0].items()}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen1.5-4b", "mistral-large-123b", "dbrx-132b",
                                  "deepseek-v2-lite-16b"])
def test_lm_model_flops_equal_jax(arch):
    """``lm_model_flops`` over ``LM_SHAPES`` on the port's LM configs
    (dense, MoE, MLA) equals the JAX package's on its own."""
    from repro.configs import common as jcommon
    from repro_torch import configs
    from repro_torch.configs import common

    mod = {m.ARCH_ID: m for m in (configs.qwen2_1_5b, configs.qwen1_5_4b,
                                  configs.mistral_large_123b, configs.dbrx_132b,
                                  configs.deepseek_v2_lite_16b)}[arch]
    assert common.LM_SHAPES == jcommon.LM_SHAPES
    cfg, jcfg = mod.full_config(), _jax_config_module(arch).full_config()
    for shape in common.LM_SHAPES.values():
        for train, decode in ((True, False), (False, False), (False, True)):
            assert common.lm_model_flops(cfg, shape["seq_len"], shape["global_batch"],
                                         train=train, decode=decode) == jcommon.lm_model_flops(
                jcfg, shape["seq_len"], shape["global_batch"], train=train, decode=decode)
