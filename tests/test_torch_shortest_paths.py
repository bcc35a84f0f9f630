"""Port parity for Bellman-Ford, widest path and betweenness.

Graphs are built in the JAX package and carried over as numpy arrays; both
packages run on the same inputs on the CPU.  Bellman-Ford and widest path
reduce integer-valued float32 weights with min or max, so the port must
equal the JAX package bit for bit, in every mode, with and without a plan,
on CSR and compressed graphs (an exception graph included).  Betweenness
sums quotients in another order: its levels must equal JAX's BFS levels bit
for bit and its scores agree within ``BC_ATOL`` (the tolerance
``tests/test_plan.py`` holds across the JAX package's own backends).  The
port is also held to the numpy/scipy oracles of ``tests/oracles.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oracles as O
from repro.algorithms import bellman_ford as jbellman_ford
from repro.algorithms import betweenness as jbetweenness
from repro.algorithms import bfs as jbfs
from repro.algorithms import widest_path as jwidest_path
from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.data import rmat_graph as jrmat_graph
from repro.data import structured_graph as jstructured_graph
from repro_torch.algorithms import bellman_ford, betweenness, widest_path
from repro_torch.algorithms.traversal import _betweenness_levels
from repro_torch.core import make_plan
from torch_parity import port_graph, to_np

BC_ATOL = 1e-4   # betweenness: float32 sums of quotients in another order
MODES = ("dense", "sparse", "sparse_streamed", "auto")


def _exception_graph():
    """n > 2^16 and few edges: hub blocks hold ESCAPE deltas (weighted)."""
    rng = np.random.default_rng(11)
    n = (1 << 17) + 3
    hubs = rng.choice(n, 10, replace=False)
    src = np.concatenate([np.repeat(hubs, 6), rng.integers(0, n, 400)])
    far = np.concatenate([rng.choice(n, 6, replace=False) for _ in hubs])
    far[:2] = 1, n - 2
    dst = np.concatenate([far, rng.integers(0, n, 400)])
    w = rng.integers(1, 9, src.shape[0]).astype(np.float32)
    return jbuild_csr(n, src, dst, w, block_size=32, symmetrize=True), int(hubs[0])


GRAPHS = {
    "rmat F_B=32": lambda: (jrmat_graph(1024, 4096, weighted=True, seed=3, block_size=32), 0),
    "rmat F_B=128": lambda: (jrmat_graph(2048, 8192, weighted=True, seed=9, block_size=128), 1),
    "exceptions": _exception_graph,
}
_GRAPHS, _WANT = {}, {}


def _graph(name, compressed):
    key = (name, compressed)
    if key not in _GRAPHS:
        jg, src = GRAPHS[name]()
        jg = jcompress(jg) if compressed else jg
        _GRAPHS[key] = (jg, port_graph(jg), src)
    return _GRAPHS[key]


def _want(name, compressed, algorithm):
    """The JAX package's result, computed once per graph (its own tests hold
    every mode and plan to the same)."""
    key = (name, compressed, algorithm)
    if key not in _WANT:
        jg, _, src = _graph(name, compressed)
        fn = {"bellman_ford": lambda: jbellman_ford(jg, src),
              "widest_path": lambda: jwidest_path(jg, src),
              "betweenness": lambda: jbetweenness(jg, src),
              "levels": lambda: jbfs(jg, src)[1]}[algorithm]
        out = fn()
        _WANT[key] = ((np.asarray(out[0]), bool(out[1])) if algorithm == "bellman_ford"
                      else np.asarray(out))
    return _WANT[key]


CASES = ([("rmat F_B=32", c, m) for c in (False, True) for m in MODES]
         + [("rmat F_B=128", True, m) for m in ("sparse_streamed", "auto")]
         + [("exceptions", True, m) for m in ("dense", "sparse_streamed")])


def _runs(fn, g, src, mode):
    """The port's result in ``mode``, and under a plan whose strategy is it."""
    plan = make_plan(g, strategy=mode, tuning=None)
    return fn(g, src, mode=mode), fn(g, src, plan=plan)


def test_exception_graph_has_exceptions():
    _, g, _ = _graph("exceptions", True)
    assert g.n_exceptions > 0


@pytest.mark.parametrize("graph,compressed,mode", CASES)
def test_bellman_ford_matches_jax(graph, compressed, mode):
    _, g, src = _graph(graph, compressed)
    want, want_neg = _want(graph, compressed, "bellman_ford")
    for dist, neg in _runs(bellman_ford, g, src, mode):
        np.testing.assert_array_equal(to_np(dist), want)
        assert neg is want_neg is False


@pytest.mark.parametrize("graph,compressed,mode", CASES)
def test_widest_path_matches_jax(graph, compressed, mode):
    _, g, src = _graph(graph, compressed)
    want = _want(graph, compressed, "widest_path")
    for width in _runs(widest_path, g, src, mode):
        np.testing.assert_array_equal(to_np(width), want)


@pytest.mark.parametrize("graph,compressed,mode", CASES)
def test_betweenness_matches_jax(graph, compressed, mode):
    _, g, src = _graph(graph, compressed)
    want = _want(graph, compressed, "betweenness")
    for delta in _runs(betweenness, g, src, mode):
        np.testing.assert_allclose(to_np(delta), want, rtol=0, atol=BC_ATOL)
    level, sigma, max_lvl = _betweenness_levels(g, src, mode=mode)
    levels = _want(graph, compressed, "levels")
    np.testing.assert_array_equal(to_np(level), levels)
    assert max_lvl == int(levels.max()) + 1
    assert bool((sigma[level >= 0] >= 1).all()) and bool((sigma[level < 0] == 0).all())


ORACLE_GRAPHS = [
    ("rmat48", lambda: jrmat_graph(48, 160, weighted=True, seed=2, block_size=32)),
    ("rmat96", lambda: jrmat_graph(96, 420, weighted=True, seed=5, block_size=32)),
] + [(kind, lambda kind=kind: jstructured_graph(kind, weighted=True))
     for kind in ("path", "grid", "two_triangles", "barbell")]


@pytest.mark.parametrize("name,make", ORACLE_GRAPHS, ids=[n for n, _ in ORACLE_GRAPHS])
def test_shortest_paths_match_oracles(name, make):
    jg = make()
    for backend in (jg, jcompress(jg)):
        g = port_graph(backend)
        dist, neg = bellman_ford(g, 0)
        assert not neg
        np.testing.assert_allclose(to_np(dist), O.bellman_ford_ref(jg, 0))
        np.testing.assert_allclose(to_np(widest_path(g, 0)), O.widest_path_ref(jg, 0))
        np.testing.assert_allclose(to_np(betweenness(g, 0)), O.betweenness_ref(jg, 0),
                                   atol=1e-3)   # the JAX package's own oracle tolerance


def test_bellman_ford_negative_cycle():
    """JAX's case: 0→1→2→0 with negative total weight, 3 hanging off 0;
    every vertex reachable from the cycle is -inf, as in JAX."""
    src, dst = np.array([0, 1, 2, 0]), np.array([1, 2, 0, 3])
    w = np.array([-1.0, -1.0, -1.0, 1.0], dtype=np.float32)
    jg = jbuild_csr(4, src, dst, w, block_size=32)
    want, want_neg = jbellman_ford(jg, 0)
    for backend in (jg, jcompress(jg)):
        for mode in MODES:
            dist, neg = bellman_ford(port_graph(backend), 0, mode=mode)
            assert neg is True and bool(want_neg)
            np.testing.assert_array_equal(to_np(dist), np.asarray(want))
            assert to_np(dist)[1] == -np.inf


def test_negative_edges_without_a_cycle():
    """A negative edge on a DAG: exact distances, no cycle flagged."""
    src, dst = np.array([0, 0, 1, 2]), np.array([1, 2, 3, 3])
    w = np.array([4.0, 1.0, -3.0, 2.0], dtype=np.float32)
    jg = jbuild_csr(5, src, dst, w, block_size=32)
    want, want_neg = jbellman_ford(jg, 0)
    dist, neg = bellman_ford(port_graph(jcompress(jg)), 0, mode="sparse_streamed")
    assert not neg and not bool(want_neg)
    np.testing.assert_array_equal(to_np(dist), np.asarray(want))
    np.testing.assert_array_equal(to_np(dist), [0.0, 4.0, 1.0, 1.0, np.inf])
