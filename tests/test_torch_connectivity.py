"""Port parity for connectivity (``ldd``, ``_min_label_prop``,
``connectivity``), personalized PageRank and the port's quickstart.

Graphs are built in the JAX package and carried over as numpy arrays;
both packages run on the same inputs on the CPU.  LDD clusters must equal
the JAX package's bit for bit given the shift array JAX draws (min over
int32); connectivity labels must equal JAX's and the scipy oracle's
whatever shifts were drawn; PPR must agree within atol 1e-6 with equal
round counts (float sums in another order), each batched row equal to its
single run bit for bit where the batch runs the single-query sweeps, and
the ACL bound must hold against the power-iteration oracle.
"""
import contextlib
import importlib.util
import io
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from oracles import components_ref
from repro.algorithms import connectivity as jconnectivity
from repro.algorithms import ldd as jldd
from repro.algorithms import personalized_pagerank as jppr
from repro.algorithms import personalized_pagerank_batched as jppr_batched
from repro.algorithms.decomposition import _min_label_prop as jmin_label_prop
from repro.algorithms.local import ppr_matrix_oracle as jppr_oracle
from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import make_plan as jmake_plan
from repro.data import rmat_graph as jrmat_graph
from repro_torch.algorithms import (
    connectivity,
    ldd,
    personalized_pagerank,
    personalized_pagerank_batched,
)
from repro_torch.algorithms.decomposition import _min_label_prop, ldd_shift
from repro_torch.algorithms.local import ppr_matrix_oracle
from repro_torch.core import make_plan
from torch_parity import port_graph, to_np

ROOT = pathlib.Path(__file__).resolve().parents[1]
PPR_ATOL = 1e-6   # float32 push sums in another order
BETA = 0.2
MODES = ("dense", "sparse", "sparse_streamed", "auto")


def _exception_graph():
    """n > 2^16 and few edges: the hubs' sorted targets lie more than 2^16
    apart, so their blocks hold ESCAPE deltas; most vertices are isolated."""
    rng = np.random.default_rng(11)
    n = (1 << 17) + 3
    hubs = rng.choice(n, 10, replace=False)
    src = np.concatenate([np.repeat(hubs, 6), rng.integers(0, n, 400)])
    far = np.concatenate([rng.choice(n, 6, replace=False) for _ in hubs])
    far[:2] = 1, n - 2          # one hub's targets span more than 2^16
    dst = np.concatenate([far, rng.integers(0, n, 400)])
    w = rng.integers(1, 9, src.shape[0]).astype(np.float32)
    return jbuild_csr(n, src, dst, w, block_size=32, symmetrize=True)


GRAPHS = {
    "rmat F_B=32": lambda: jrmat_graph(1024, 4096, weighted=True, seed=3, block_size=32),
    "rmat F_B=128": lambda: jrmat_graph(4096, 8192, weighted=True, seed=9, block_size=128),
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
    return jnp.minimum(shift, jnp.float32(2.0 * jnp.log(n + 1) / beta))


def test_exception_graph_has_exceptions():
    _, g = _graph("exceptions", True)
    assert g.n_exceptions > 0


# ----------------------------------------------------------------------
# LDD and connectivity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("graph,compressed,mode",
                         [("rmat F_B=32", c, m) for c in (False, True) for m in MODES]
                         + [("exceptions", True, m) for m in ("dense", "sparse_streamed")])
def test_ldd_matches_jax_on_its_shift(graph, compressed, mode):
    jg, g = _graph(graph, compressed)
    key = jax.random.PRNGKey(len(graph) + len(mode))
    want = np.asarray(jldd(jg, BETA, key, mode=mode))
    shift = torch.from_numpy(np.array(_jax_shift(jg.n, BETA, key)))
    got = to_np(ldd(g, BETA, shift=shift, mode=mode))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()
    # under a plan as well, whose strategy names the mode
    plan = make_plan(g, strategy=mode, tuning=None)
    np.testing.assert_array_equal(to_np(ldd(g, BETA, shift=shift, plan=plan)), want)


def test_ldd_draws_from_its_generator():
    _, g = _graph("rmat F_B=32", True)
    a = ldd(g, BETA, torch.Generator().manual_seed(5))
    b = ldd(g, BETA, shift=ldd_shift(g.n, BETA, torch.Generator().manual_seed(5)))
    assert torch.equal(a, b)
    shift = ldd_shift(g.n, BETA, torch.Generator().manual_seed(5))
    assert shift.dtype == torch.float32 and float(shift.min()) >= 0.0
    assert float(shift.max()) <= 2.0 * np.log(g.n + 1) / BETA + 1e-4
    with pytest.raises(ValueError, match="generator or a shift"):
        ldd(g, BETA)


@pytest.mark.parametrize("graph,compressed",
                         [("rmat F_B=32", False), ("rmat F_B=128", True),
                          ("exceptions", True)])
@pytest.mark.parametrize("use_ldd", [True, False])
def test_connectivity_matches_jax_and_oracle(graph, compressed, use_ldd):
    jg, g = _graph(graph, compressed)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jconnectivity(jg, key, use_ldd=use_ldd))
    np.testing.assert_array_equal(want, components_ref(jg))
    shift = torch.from_numpy(np.array(_jax_shift(jg.n, BETA, key)))
    got = to_np(connectivity(g, use_ldd=use_ldd, shift=shift))
    np.testing.assert_array_equal(got, want)
    # other shifts, drawn by the port: the same canonical labels
    plan = make_plan(g, strategy="sparse_streamed", tuning=None)
    other = connectivity(g, torch.Generator().manual_seed(3), use_ldd=use_ldd, plan=plan)
    np.testing.assert_array_equal(to_np(other), want)


@pytest.mark.parametrize("compressed", [False, True])
def test_min_label_prop_with_edge_active_and_vertex_mask(compressed):
    jg, g = _graph("rmat F_B=32", compressed)
    rng = np.random.default_rng(2)
    active = rng.random(jg.num_blocks * jg.block_size) < 0.6
    vmask = rng.random(jg.n) < 0.8
    labels0 = np.arange(jg.n, dtype=np.int32)
    for kw in ({"edge_active": active}, {"vertex_mask": vmask},
               {"edge_active": active, "vertex_mask": vmask}):
        want = np.asarray(jmin_label_prop(jg, jnp.asarray(labels0),
                                          **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = _min_label_prop(g, torch.from_numpy(labels0),
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_array_equal(to_np(got), want)
        assert (want != labels0).any()


# ----------------------------------------------------------------------
# Personalized PageRank
# ----------------------------------------------------------------------
PPR_SOURCES = [5, 17, 300, 1000]


@pytest.mark.parametrize("graph,compressed,strategy",
                         [("rmat F_B=32", True, s) for s in MODES]
                         + [("rmat F_B=32", False, "auto"), ("rmat F_B=128", True, "auto"),
                            ("exceptions", True, "sparse_streamed")])
def test_ppr_matches_jax(graph, compressed, strategy):
    jg, g = _graph(graph, compressed)
    srcs = PPR_SOURCES if graph != "exceptions" else [int(np.argmax(np.asarray(jg.degrees))),
                                                      5, 17, 300]
    jplan = jmake_plan(jg, strategy=strategy, tuning=None)
    plan = make_plan(g, strategy=strategy, tuning=None)
    kw = dict(eps=1e-5, max_rounds=60)
    jp, jr, jrounds = jppr_batched(jg, srcs, plan=jplan, **kw)
    p, r, rounds = personalized_pagerank_batched(g, srcs, plan=plan, **kw)
    np.testing.assert_array_equal(to_np(rounds), np.asarray(jrounds))
    np.testing.assert_allclose(to_np(p), np.asarray(jp), rtol=0, atol=PPR_ATOL)
    np.testing.assert_allclose(to_np(r), np.asarray(jr), rtol=0, atol=PPR_ATOL)
    # the streamed batch shares each chunk across lanes, so its float sums
    # associate otherwise; every other strategy runs each row's own sweeps
    exact = not (compressed and strategy == "sparse_streamed")
    wp, _, wrounds = jppr(jg, srcs[0], plan=jplan, **kw)
    for i, s in enumerate(srcs):
        sp, sr, srounds = personalized_pagerank(g, s, plan=plan, **kw)
        assert srounds == int(rounds[i])
        if i == 0:
            assert srounds == int(wrounds)
            np.testing.assert_allclose(to_np(sp), np.asarray(wp), rtol=0, atol=PPR_ATOL)
        if exact:
            assert torch.equal(p[i], sp) and torch.equal(r[i], sr)
        else:
            np.testing.assert_allclose(to_np(p[i]), to_np(sp), rtol=0, atol=PPR_ATOL)


def test_ppr_capped_lane_freezes():
    """A lane capped by ``max_rounds`` stops with the rest still running:
    its rounds stop at the cap and its rows equal the capped single run."""
    jg, g = _graph("rmat F_B=32", False)
    kw = dict(eps=1e-7, max_rounds=3)
    p, r, rounds = personalized_pagerank_batched(g, [5, 17], **kw)
    assert to_np(rounds).tolist() == [3, 3]
    single = personalized_pagerank(g, 17, **kw)
    assert torch.equal(p[1], single[0]) and single[2] == 3
    jp, _, jrounds = jppr_batched(jg, [5, 17], **kw)
    np.testing.assert_array_equal(to_np(rounds), np.asarray(jrounds))
    np.testing.assert_allclose(to_np(p), np.asarray(jp), rtol=0, atol=PPR_ATOL)


@pytest.mark.parametrize("compressed", [False, True])
def test_ppr_acl_bound_against_oracle(compressed):
    jg, g = _graph("rmat F_B=32", compressed)
    eps = 1e-6
    deg = np.maximum(to_np(g.degrees), 1)
    for s in (5, 300):
        pi = ppr_matrix_oracle(g, s)
        np.testing.assert_allclose(pi, jppr_oracle(jg, s), rtol=0, atol=1e-12)
        p, _, rounds = personalized_pagerank(g, s, eps=eps)
        assert 0 < rounds < 200
        assert (np.abs(to_np(p).astype(np.float64) - pi) <= eps * deg + 1e-7).all()


# ----------------------------------------------------------------------
# The quickstart
# ----------------------------------------------------------------------
def _run_example(name, argv):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(*argv)
    return out.getvalue().splitlines()


def test_quickstart_torch_prints_the_quickstart_lines():
    want = _run_example("quickstart", [])
    got = _run_example("quickstart_torch", [["--device", "cpu"]])
    assert len(got) == len(want)
    same = ("graph:", "BFS from 0", "connectivity:", "k-core", "triangles", "filter:",
            "served", "PSAM accounting")
    for a, b in zip(got, want):
        if a.startswith(same):
            assert a == b
    assert [a for a in got if a.startswith(same)] and got[1].startswith("plan: plan[single")
