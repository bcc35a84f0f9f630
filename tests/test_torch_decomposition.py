"""Port parity for multi-source BFS, spanning forest, the O(k)-spanner and
biconnectivity.

Graphs are built in the JAX package and carried over as numpy arrays; both
packages run on the same inputs on the CPU.  Every result here is integer
or boolean and must equal the JAX package's bit for bit: the spanner given
the LDD shift JAX draws (``shift=``), the spanning forest with and without
LDD, on CSR and compressed graphs (an exception graph included).  The
helpers the spanner and biconnectivity sort with (``_symmetrize_slot_mask``,
``_euler_tour_preorder``) are held to JAX's as well, and the results to the
validity checks of ``tests/oracles.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import oracles as O
from repro.algorithms import biconnectivity as jbiconnectivity
from repro.algorithms import multi_source_bfs as jmulti_source_bfs
from repro.algorithms import spanner as jspanner
from repro.algorithms import spanning_forest as jspanning_forest
from repro.algorithms.decomposition import _euler_tour_preorder as jeuler_tour_preorder
from repro.algorithms.decomposition import _symmetrize_slot_mask as jsymmetrize
from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.data import rmat_graph as jrmat_graph
from repro.data import structured_graph as jstructured_graph
from repro_torch.algorithms import (
    biconnectivity,
    connectivity,
    multi_source_bfs,
    spanner,
    spanning_forest,
)
from repro_torch.algorithms.decomposition import (
    _euler_tour_preorder,
    _symmetrize_slot_mask,
    ldd_shift,
)
from repro_torch.core import make_plan
from torch_parity import port_graph, to_np

MODES = ("dense", "sparse", "sparse_streamed", "auto")
LDD_BETA = 0.2   # connectivity's LDD, as in the JAX package


def _exception_graph():
    """n > 2^16 and few edges: hub blocks hold ESCAPE deltas."""
    rng = np.random.default_rng(11)
    n = (1 << 17) + 3
    hubs = rng.choice(n, 10, replace=False)
    src = np.concatenate([np.repeat(hubs, 6), rng.integers(0, n, 400)])
    far = np.concatenate([rng.choice(n, 6, replace=False) for _ in hubs])
    far[:2] = 1, n - 2
    dst = np.concatenate([far, rng.integers(0, n, 400)])
    return jbuild_csr(n, src, dst, block_size=32, symmetrize=True)


GRAPHS = {
    "rmat F_B=32": lambda: jrmat_graph(1024, 4096, weighted=True, seed=3, block_size=32),
    "rmat F_B=128": lambda: jrmat_graph(1024, 4096, seed=9, block_size=128),
    "exceptions": _exception_graph,
}
_CACHE = {}


def _graph(name, compressed):
    key = (name, compressed)
    if key not in _CACHE:
        jg = GRAPHS[name]()
        jg = jcompress(jg) if compressed else jg
        _CACHE[key] = (jg, port_graph(jg))
    return _CACHE[key]


def _jax_shift(n, beta, key):
    """The shift array ``repro.algorithms.ldd`` draws from ``key``."""
    shift = jax.random.exponential(key, (n,), dtype=jnp.float32) / beta
    return torch.from_numpy(np.array(jnp.minimum(shift, jnp.float32(2.0 * jnp.log(n + 1) / beta))))


def _spanner_beta(n, k):
    """The spanner's β as the JAX package computes it."""
    return float(jnp.log(n + 1)) / (2.0 * k)


def test_exception_graph_has_exceptions():
    _, g = _graph("exceptions", True)
    assert g.n_exceptions > 0


@pytest.mark.parametrize("compressed", (False, True))
@pytest.mark.parametrize("mode", MODES)
def test_multi_source_bfs_matches_jax(compressed, mode):
    jg, g = _graph("rmat F_B=32", compressed)
    roots = np.random.default_rng(5).random(g.n) < 0.01
    want_p, want_l = jmulti_source_bfs(jg, jnp.asarray(roots), mode=mode)
    for kw in ({"mode": mode}, {"plan": make_plan(g, strategy=mode, tuning=None)}):
        parents, levels = multi_source_bfs(g, torch.from_numpy(roots), **kw)
        np.testing.assert_array_equal(to_np(parents), np.asarray(want_p))
        np.testing.assert_array_equal(to_np(levels), np.asarray(want_l))


@pytest.mark.parametrize("graph,compressed", [("rmat F_B=32", False), ("rmat F_B=32", True),
                                              ("exceptions", True)])
def test_spanning_forest_matches_jax(graph, compressed):
    jg, g = _graph(graph, compressed)
    key = jax.random.PRNGKey(3)
    want = [np.asarray(t) for t in jspanning_forest(jg, None)]
    for got in (spanning_forest(g),
                spanning_forest(g, shift=_jax_shift(g.n, LDD_BETA, key)),
                spanning_forest(g, torch.Generator().manual_seed(1))):
        np.testing.assert_array_equal(to_np(got[0]), want[0])
        np.testing.assert_array_equal(to_np(got[1]), want[1])
    with_ldd = [np.asarray(t) for t in jspanning_forest(jg, key)]
    np.testing.assert_array_equal(with_ldd[0], want[0])


@pytest.mark.parametrize("graph,compressed,k", [("rmat F_B=32", False, 4),
                                                ("rmat F_B=32", True, 4),
                                                ("rmat F_B=32", True, 2),
                                                ("rmat F_B=128", False, 3)])
def test_spanner_matches_jax_on_its_shift(graph, compressed, k):
    jg, g = _graph(graph, compressed)
    key = jax.random.PRNGKey(7 + k)
    want_mask, want_ok = jspanner(jg, k, key)
    shift = _jax_shift(g.n, _spanner_beta(g.n, k), key)
    mask, ok = spanner(g, k, shift=shift)
    np.testing.assert_array_equal(to_np(mask), np.asarray(want_mask))
    assert ok is bool(want_ok) is True
    # the mask lies on real slots only
    valid = to_np(g.edge_valid)
    m = to_np(mask)
    assert not (m & ~valid).any()


def test_spanner_cap_overflow_matches_jax():
    """A cap far under the inter-cluster count: ``ok`` is False and the
    (truncated) picks still equal JAX's."""
    jg, g = _graph("rmat F_B=32", True)
    key = jax.random.PRNGKey(2)
    want_mask, want_ok = jspanner(jg, 4, key, inter_cap_factor=0)
    mask, ok = spanner(g, 4, shift=_jax_shift(g.n, _spanner_beta(g.n, 4), key),
                       inter_cap_factor=0)
    assert ok is False and not bool(want_ok)
    np.testing.assert_array_equal(to_np(mask), np.asarray(want_mask))


def test_spanner_draws_from_its_generator():
    _, g = _graph("rmat F_B=32", True)
    a = spanner(g, 4, torch.Generator().manual_seed(5))
    shift = ldd_shift(g.n, _spanner_beta(g.n, 4), torch.Generator().manual_seed(5))
    b = spanner(g, 4, shift=shift)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]


@pytest.mark.parametrize("compressed", (False, True))
def test_symmetrize_slot_mask_matches_jax(compressed):
    jg, g = _graph("rmat F_B=32", compressed)
    mask = np.random.default_rng(4).random(g.edge_src.shape[0]) < 0.3
    want = np.asarray(jsymmetrize(jg, jnp.asarray(mask)))
    got = to_np(_symmetrize_slot_mask(g, torch.from_numpy(mask)))
    np.testing.assert_array_equal(got, want)
    # symmetric: (u, v) kept iff (v, u) kept
    src, dst = to_np(g.edge_src), to_np(g.edge_dst)
    kept = {(int(a), int(b)) for a, b in zip(src[got], dst[got])}
    assert all((b, a) in kept for a, b in kept)


@pytest.mark.parametrize("graph", ("rmat F_B=32", "exceptions"))
def test_euler_tour_preorder_matches_jax(graph):
    jg, g = _graph(graph, True)
    labels = connectivity(g, use_ldd=False)
    roots = labels == torch.arange(g.n, dtype=torch.int32)
    parents, _ = multi_source_bfs(g, roots)
    want = jeuler_tour_preorder(jg, jnp.asarray(to_np(parents)), jnp.asarray(to_np(labels)))
    got = _euler_tour_preorder(g, parents, labels)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    pre = to_np(got[0])
    assert sorted(pre.tolist()) == list(range(g.n))   # a permutation


@pytest.mark.parametrize("graph,compressed", [("rmat F_B=32", False), ("rmat F_B=32", True),
                                              ("rmat F_B=128", True), ("exceptions", True)])
def test_biconnectivity_matches_jax(graph, compressed):
    jg, g = _graph(graph, compressed)
    want = np.asarray(jbiconnectivity(jg))
    got = to_np(biconnectivity(g))
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) == to_np(g.edge_valid)).all()


ORACLE_GRAPHS = [
    ("rmat48", lambda: jrmat_graph(48, 160, weighted=True, seed=2, block_size=32)),
    ("rmat96", lambda: jrmat_graph(96, 420, weighted=True, seed=5, block_size=32)),
] + [(kind, lambda kind=kind: jstructured_graph(kind, weighted=True))
     for kind in ("path", "grid", "two_triangles", "barbell")]


@pytest.mark.parametrize("name,make", ORACLE_GRAPHS, ids=[n for n, _ in ORACLE_GRAPHS])
def test_decomposition_passes_oracles(name, make):
    jg = make()
    for backend in (jg, jcompress(jg)):
        g = port_graph(backend)
        gen = torch.Generator().manual_seed(0)
        ok, msg = O.check_spanning_forest(jg, *[to_np(t) for t in spanning_forest(g, gen)])
        assert ok, msg
        mask, fits = spanner(g, 4, torch.Generator().manual_seed(1))
        assert fits
        ok, msg = O.check_spanner(jg, to_np(mask), 4)
        assert ok, msg
        ok, msg = O.check_bicomp(jg, to_np(biconnectivity(g)))
        assert ok, msg
