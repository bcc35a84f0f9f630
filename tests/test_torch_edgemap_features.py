"""Port parity for batched edgeMap over feature-dim vertex state: the port's
``edgemap_reduce_batched`` on ``xb`` of shape (B, n, d) against the JAX
package's, which vmaps ``edgemap_reduce`` over the lanes.

Every mode (``dense``, ``sparse``, ``sparse_streamed``, ``auto``; JAX
demotes ``sparse_streamed`` to ``sparse``, the port keeps kernel 1's decode
a lane, whose tile is bit for bit the un-streamed one), the ``sum``, ``min``
and ``max`` monoids, a CSR graph and a compressed graph with exceptions,
with and without ``map_lanes`` and ``edge_active``; lanes of mixed
frontier density, so that ``auto`` takes each lane's own Beamer branch.
min and max are held bit for bit, sums within ``SUM_ATOL``; ``touched``
exactly.  Then the same batch on the port's (2,) in-process mesh under
``flat``, and the hierarchical combine's refusal of a 3-D state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import edgemap_reduce_batched as jedgemap_reduce_batched
from repro.data import rmat_graph as jrmat_graph
from repro_torch.core import edgemap_reduce, edgemap_reduce_batched, make_mesh, make_plan
from repro_torch.core.compressed import exception_dense
from torch_parity import port_graph, to_np

SUM_ATOL = 1e-5   # float32 sums in another order (tests/test_torch_sharding.py)
B, D = 4, 3
MODES = ("dense", "sparse", "sparse_streamed", "auto")
CPU = torch.device("cpu")
_CACHE = {}


def _exception_graph():
    """n = 70,000 with wide gaps: exception rows over 3 sources."""
    n = 70000
    src = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 3, 3, 2], np.int64)
    dst = np.array([1, 2, 66000, 66001, 69998, 69999, 3, 69000, 69500, 68000, 1, 0], np.int64)
    return jbuild_csr(n, src, dst, block_size=32)


GRAPHS = {
    "csr": lambda: jrmat_graph(192, 768, weighted=True, seed=17, block_size=32),
    "compressed exceptions": lambda: jcompress(_exception_graph()),
}


def _graph(name):
    if name not in _CACHE:
        jg = GRAPHS[name]()
        _CACHE[name] = (jg, port_graph(jg))
    return _CACHE[name]


def _maps(monoid):
    """(JAX map, port map) of a monoid's test: a weighted product for the
    float sum, a weight added to the int32 label for min and max."""
    if monoid == "sum":
        return (lambda xs, w: xs * w), (lambda xs, w: xs * w)
    return (lambda xs, w: xs + w.astype(jnp.int32)), (lambda xs, w: xs + w.to(torch.int32))


def _inputs(g, monoid):
    rng = np.random.default_rng(5)
    if monoid == "sum":
        x = rng.standard_normal((B, g.n, D)).astype(np.float32)
    else:
        x = rng.integers(-1000, 1000, (B, g.n, D)).astype(np.int32)
    # lanes from full to empty: auto takes a dense and a sparse branch
    density = np.array([1.0, 0.05, 0.0, 0.3])[:, None]
    fr = rng.random((B, g.n)) < density
    fr[1, :4] = True
    active = to_np(g.edge_valid) & (rng.random(g.num_blocks * g.block_size) < 0.6)
    lanes = np.array([True, False, True, False])
    return x, fr, active, lanes


def _want(name, monoid, variant, mode):
    """JAX's vmapped result, computed once a case."""
    key = (name, monoid, variant, mode)
    if key not in _CACHE:
        jg, g = _graph(name)
        x, fr, active, lanes = _inputs(g, monoid)
        jmap, _ = _maps(monoid)
        kw = {} if variant == "plain" else {"map_lanes": jnp.asarray(lanes),
                                            "edge_active": jnp.asarray(active)}
        out = jedgemap_reduce_batched(jg, jnp.asarray(fr), jnp.asarray(x), monoid=monoid,
                                      map_fn=jmap, mode=mode, **kw)
        _CACHE[key] = tuple(np.asarray(o) for o in out)
    return _CACHE[key]


def _same(got, want, monoid):
    out, touched = (to_np(t) for t in got)
    assert out.shape == want[0].shape and out.dtype == want[0].dtype
    np.testing.assert_array_equal(touched, want[1])
    if monoid == "sum":
        np.testing.assert_allclose(out, want[0], rtol=0, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(out, want[0])


def _port_kwargs(g, monoid, variant):
    x, fr, active, lanes = (torch.from_numpy(a) for a in _inputs(g, monoid))
    kw = {} if variant == "plain" else {"map_lanes": lanes, "edge_active": active}
    return x, fr, kw


@pytest.mark.parametrize("variant", ["plain", "lanes+filter"])
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_feature_batched_equals_jax(graph, monoid, variant):
    """Every mode against JAX's vmapped lanes, and every lane against the
    port's own single-query run."""
    jg, g = _graph(graph)
    assert graph == "csr" or (g.n_exceptions > 0 and not exception_dense(g))
    x, fr, kw = _port_kwargs(g, monoid, variant)
    _, pmap = _maps(monoid)
    for mode in MODES:
        got = edgemap_reduce_batched(g, fr, x, monoid=monoid, map_fn=pmap, mode=mode, **kw)
        _same(got, _want(graph, monoid, variant, mode), monoid)
        for q in range(B):
            lane_map = pmap
            if "map_lanes" in kw and not bool(kw["map_lanes"][q]):
                lane_map = lambda xs, w: xs  # noqa: E731
            one = edgemap_reduce(g, fr[q], x[q], monoid=monoid, map_fn=lane_map, mode=mode,
                                 edge_active=kw.get("edge_active"))
            assert torch.equal(got[0][q], one[0]) and torch.equal(got[1][q], one[1]), (mode, q)


@pytest.mark.parametrize("variant", ["plain", "lanes+filter"])
@pytest.mark.parametrize("monoid", ["sum", "min", "max"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_feature_batched_on_a_mesh_equals_jax(graph, monoid, variant):
    """The same batches on a (2,) in-process mesh, ``flat``: each shard's
    lanes, then one combine of the (B, n, d) outputs."""
    _, g = _graph(graph)
    plan = make_plan(g, mesh=make_mesh((2,), ("data",), devices=[CPU] * 2), tuning=None)
    gs = plan.prepare(g)
    x, fr, kw = _port_kwargs(g, monoid, variant)
    _, pmap = _maps(monoid)
    for mode in MODES:
        got = edgemap_reduce_batched(gs, fr, x, monoid=monoid, map_fn=pmap, mode=mode,
                                     plan=plan, **kw)
        _same(got, _want(graph, monoid, variant, mode), monoid)


def test_hierarchical_refuses_feature_dims():
    """As the JAX package's: the hierarchical sum takes 1-D or (B, n) only."""
    _, g = _graph("csr")
    plan = make_plan(g, mesh=make_mesh((2, 2), ("pod", "data"), devices=[CPU] * 4),
                     reduce_mode="hierarchical", tuning=None)
    x, fr, _ = _port_kwargs(g, "sum", "plain")
    with pytest.raises(NotImplementedError, match="1-D or"):
        edgemap_reduce_batched(plan.prepare(g), fr, x, monoid="sum", mode="dense", plan=plan)
