"""Port parity for the rest of the core: the primitives, ``graph_spec``, the
PSAM charges, ``edgemap_sum_compressed`` and the port's graph-analytics
example.

Inputs are made with numpy from a seed and go through the JAX package and
the port on the CPU.  The primitives and the PSAM words (fields and the
mirrored ``sage_psam_*_words_total`` counters) must equal JAX's exactly;
``edgemap_sum_compressed`` within ``SUM_RTOL`` / ``SUM_ATOL`` for float32 x
(per-block sums in another order) and exactly for int32 x (both packages
promote it and sum in float32, exact at these sizes).
"""
import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import edgemap_sum_compressed as jedgemap_sum_compressed
from repro.core import filter_edges as jfilter_edges
from repro.core import graph_spec as jgraph_spec
from repro.core import make_filter as jmake_filter
from repro.core import primitives as jprim
from repro.core.psam import PSAMCost as JPSAMCost
from repro.data import rmat_graph as jrmat_graph
from repro.obs import Registry as JRegistry
from repro_torch.core import (
    PSAMCost,
    edgemap_sum_compressed,
    exception_dense,
    exclusive_scan,
    filter_from_reference_arrays,
    graph_spec,
    histogram,
    lowest_set_bit,
    mex_from_forbidden,
)
from repro_torch.core.convert import FILTER_FIELDS, FILTER_META
from repro_torch.obs import Registry
from torch_parity import CPU, port_graph, to_np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUM_RTOL = 1e-5   # float32 sums: the port sums each block, then the owners, in another order
SUM_ATOL = 1e-5
NP_DTYPES = {torch.int32: np.int32, torch.float32: np.float32}


# ----------------------------------------------------------------------
# primitives
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,size", [(np.int32, 1000), (np.int32, 1), (np.int32, 0),
                                        (np.float32, 777)])
def test_exclusive_scan_matches_jax(dtype, size):
    rng = np.random.default_rng(size)
    x = (rng.integers(-50, 50, size) if dtype == np.int32 else rng.random(size)).astype(dtype)
    want = [np.asarray(t) for t in jprim.exclusive_scan(jnp.asarray(x))]
    got = [to_np(t) for t in exclusive_scan(torch.from_numpy(x))]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        if dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        else:  # a float cumsum in one sequential order on both sides
            np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("weighted", (False, True))
def test_histogram_matches_jax(weighted):
    rng = np.random.default_rng(3)
    ids = rng.integers(-3, 70, 5000).astype(np.int32)   # some out of range: dropped
    w = rng.integers(-5, 9, 5000).astype(np.int32) if weighted else None
    want = np.asarray(jprim.histogram(jnp.asarray(ids), 64,
                                      None if w is None else jnp.asarray(w)))
    got = to_np(histogram(torch.from_numpy(ids), 64, None if w is None else torch.from_numpy(w)))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _words(shape, seed):
    """uint32 words with the edge cases planted: 0, all ones, bit 31 alone."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    # sparse words, so the lowest set bit lands high as well
    flat[4::3] &= rng.integers(0, 2**32, flat[4::3].shape, dtype=np.uint64).astype(np.uint32)
    bit = rng.integers(0, 32, flat[5::3].shape).astype(np.uint32)
    flat[5::3] = np.left_shift(np.uint32(1), bit)
    return w


def test_lowest_set_bit_matches_jax():
    w = _words((4096,), 1)
    want = np.asarray(jprim.lowest_set_bit(jnp.asarray(w)))
    got = to_np(lowest_set_bit(torch.from_numpy(w.view(np.int32))))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("W", (1, 2, 8))
def test_mex_from_forbidden_matches_jax(W):
    w = _words((512, W), W)
    w[7] = 0xFFFFFFFF           # every color forbidden: mex = 32·W
    w[8, : W - 1] = 0xFFFFFFFF  # the first free bit in the last word
    want = np.asarray(jprim.mex_from_forbidden(jnp.asarray(w)))
    got = to_np(mex_from_forbidden(torch.from_numpy(w.view(np.int32))))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[7] == 32 * W


@pytest.mark.parametrize("weighted", (False, True))
def test_graph_spec_matches_jax(weighted):
    want = jgraph_spec(1000, 37, 64, weighted)
    got = graph_spec(1000, 37, 64, weighted)
    for f in ("offsets", "block_offsets", "block_src", "edge_src", "edge_dst", "edge_w",
              "degrees"):
        t, s = getattr(got, f), getattr(want, f)
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape) and NP_DTYPES[t.dtype] == s.dtype, f
    for f in ("n", "m", "num_blocks", "block_size", "weighted"):
        assert getattr(got, f) == getattr(want, f)


# ----------------------------------------------------------------------
# PSAM charges
# ----------------------------------------------------------------------
_GRAPHS = {}


def _graphs(kind):
    """(JAX graph, port graph, JAX filter, port filter): a filter that kills
    every edge out of the top two thirds of the ids, so many blocks die."""
    if kind not in _GRAPHS:
        jg = jrmat_graph(512, 4096, weighted=kind != "compressed unweighted", seed=4,
                         block_size=32)
        jf, _ = jfilter_edges(jg, jmake_filter(jg), jg.edge_valid & (jg.edge_src < jg.n // 3))
        backend = jg if kind == "csr" else jcompress(jg)
        f = filter_from_reference_arrays({k: np.asarray(getattr(jf, k)) for k in FILTER_FIELDS},
                                         {k: getattr(jf, k) for k in FILTER_META}, CPU)
        _GRAPHS[kind] = (backend, port_graph(backend), jf, f)
    return _GRAPHS[kind]


def _charges(cost, g, f, shards, live):
    filt = {"none": None, "int": None if f is None else int(f.block_live.sum()),
            "filter": f}[live]
    cost.charge_edgemap_dense(g)
    cost.charge_edgemap_chunked(g, 37)
    cost.charge_edgemap_planned(g, num_shards=shards, filter_live_blocks=filt)
    cost.charge_edgemap_planned(g, num_shards=shards, active_blocks=11,
                                filter_live_blocks=filt)
    cost.charge_edgemap_batched(g, 8, num_shards=shards, filter_live_blocks=filt)
    cost.charge_edgemap_batched(g, 3, num_shards=shards, active_blocks=5,
                                filter_live_blocks=filt)
    cost.charge_edgemap_sparse(g, 41, batch=2, num_shards=shards, tile_blocks=8)
    cost.charge_filter_pack(g, 19)
    cost.charge_large_write(123)
    cost.charge_large_write(7, label="compact")
    cost.charge_small(55)


@pytest.mark.parametrize("kind", ("csr", "compressed", "compressed unweighted"))
@pytest.mark.parametrize("shards", (1, 4))
@pytest.mark.parametrize("live", ("none", "int", "filter"))
def test_psam_charges_match_jax(kind, shards, live):
    jg, g, jf, f = _graphs(kind)
    jreg, reg = JRegistry(), Registry()
    jcost, cost = JPSAMCost(registry=jreg), PSAMCost(registry=reg)
    _charges(jcost, jg, jf, shards, live)
    _charges(cost, g, f, shards, live)
    for field in ("large_reads", "small_ops", "large_writes", "work"):
        assert getattr(cost, field) == getattr(jcost, field), field
    assert cost.gbbs_equivalent_work(g.m) == jcost.gbbs_equivalent_work(jg.m)
    jsnap, snap = jreg.snapshot(), reg.snapshot()
    names = {k for k in jsnap if k.startswith("sage_psam_")}
    assert names == {k for k in snap if k.startswith("sage_psam_")} and len(names) == 3
    for name in names:
        assert snap[name]["series"] == jsnap[name]["series"], name
    # a live-block filter charges fewer reads than the dense pass
    if live != "none":
        dense, filtered = PSAMCost(registry=Registry()), PSAMCost(registry=Registry())
        dense.charge_edgemap_planned(g, num_shards=shards)
        filtered.charge_edgemap_planned(g, num_shards=shards, filter_live_blocks=f)
        assert filtered.large_reads < dense.large_reads


# ----------------------------------------------------------------------
# edgemap_sum_compressed
# ----------------------------------------------------------------------
def _exception_dense_graph():
    """n = 2^20 and a few hundred sources with spread targets: most deltas
    are exceptions, past the limit, so the exact decode runs."""
    rng = np.random.default_rng(8)
    n = 1 << 20
    src = np.repeat(rng.choice(n, 300, replace=False), 5)
    dst = rng.integers(0, n, src.shape[0])
    w = rng.integers(1, 9, src.shape[0]).astype(np.float32)
    return jbuild_csr(n, src, dst, w, block_size=32, symmetrize=True)


def _exception_graph():
    rng = np.random.default_rng(11)
    n = (1 << 17) + 3
    hubs = rng.choice(n, 10, replace=False)
    src = np.concatenate([np.repeat(hubs, 6), rng.integers(0, n, 400)])
    far = np.concatenate([rng.choice(n, 6, replace=False) for _ in hubs])
    far[:2] = 1, n - 2
    dst = np.concatenate([far, rng.integers(0, n, 400)])
    w = rng.integers(1, 9, src.shape[0]).astype(np.float32)
    return jbuild_csr(n, src, dst, w, block_size=32, symmetrize=True)


SUM_GRAPHS = {
    "rmat weighted": lambda: jrmat_graph(1024, 8192, weighted=True, seed=6, block_size=64),
    "exceptions": _exception_graph,
    "exception-dense": _exception_dense_graph,
}
_SUM_CACHE = {}


def _sum_graph(name):
    if name not in _SUM_CACHE:
        jc = jcompress(SUM_GRAPHS[name]())
        _SUM_CACHE[name] = (jc, port_graph(jc))
    return _SUM_CACHE[name]


@pytest.mark.parametrize("graph", tuple(SUM_GRAPHS))
@pytest.mark.parametrize("dtype", (np.float32, np.int32))
@pytest.mark.parametrize("filtered", (False, True))
def test_edgemap_sum_compressed_matches_jax(graph, dtype, filtered):
    jc, c = _sum_graph(graph)
    assert c.weighted and (c.n_exceptions > 0) == (graph != "rmat weighted")
    assert exception_dense(c) == (graph == "exception-dense")
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(c.n) if dtype == np.float32
         else rng.integers(-20, 20, c.n)).astype(dtype)
    active = None
    if filtered:
        active = to_np(c.edge_valid) & (rng.random(c.num_blocks * c.block_size) < 0.6)
    want = np.asarray(jedgemap_sum_compressed(jc, jnp.asarray(x), edge_active=(
        None if active is None else jnp.asarray(active))))
    got = edgemap_sum_compressed(c, torch.from_numpy(x), edge_active=(
        None if active is None else torch.from_numpy(active)))
    # an int32 x is promoted: float32 sums, as the JAX package's
    assert got.dtype == torch.float32 and to_np(got).dtype == want.dtype
    assert tuple(got.shape) == (c.n,)
    if dtype == np.int32:
        np.testing.assert_array_equal(to_np(got), want)
    else:
        np.testing.assert_allclose(to_np(got), want, rtol=SUM_RTOL, atol=SUM_ATOL)
    # unweighted even on a weighted graph: the degree (or the active count) for x = 1
    ones = edgemap_sum_compressed(c, torch.ones(c.n, dtype=torch.int32), edge_active=(
        None if active is None else torch.from_numpy(active)))
    if active is None:
        np.testing.assert_array_equal(to_np(ones), to_np(c.degrees))
    else:
        src = to_np(c.edge_src)
        np.testing.assert_array_equal(to_np(ones), np.bincount(src[active], minlength=c.n))


# ----------------------------------------------------------------------
# the example
# ----------------------------------------------------------------------
def _run_example(name, argv):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(*argv)
    return out.getvalue().splitlines()


def test_graph_analytics_torch_prints_the_example_lines():
    """The port's example runs to its end on the CPU and prints the JAX
    example's lines (matching, orientation, triangles, k-core, PSAM work);
    only the plan's description differs."""
    want = _run_example("graph_analytics", [])
    got = _run_example("graph_analytics_torch", [["--device", "cpu"]])
    assert len(got) == len(want) == 7
    assert got[0].split(";")[0] == want[0].split(";")[0]
    assert "plan[single-device backend=csr strategy=auto route=torch" in got[0]
    assert got[1:] == want[1:]
