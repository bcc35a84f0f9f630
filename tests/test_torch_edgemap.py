"""Port parity for edgeMap in its four modes, single and batched.

The same graph, frontier and vertex state go through ``repro.core`` and
``repro_torch.core``.  min-monoid results and ``touched`` masks must be
identical; sum-monoid float results agree within rtol 1e-5, because the two
packages add the contributions of a vertex in different orders.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import edgemap_reduce as jreduce
from repro.core import edgemap_reduce_batched as jreduce_batched
from repro.core import make_plan as jmake_plan
from repro.data import rmat_graph as jrmat_graph
from repro_torch.core import (
    edge_map,
    edgemap_reduce,
    edgemap_reduce_batched,
    exception_dense,
    make_plan,
)
from repro_torch.core.vertex_subset import from_indices
from torch_parity import port_graph, to_np

SUM_RTOL = 1e-5  # float sums: contributions are added in another order
MODES = ("dense", "sparse", "sparse_streamed", "auto")


def _wide_graph():
    """Compressed with a few ≥2¹⁶ exceptions, under the exception limit."""
    rng = np.random.default_rng(1)
    src = np.concatenate([np.zeros(30, np.int64), rng.integers(1, 48, 200)])
    # vertex 0's targets end with a gap of more than 2^16 (1, ..., 69999)
    far = np.concatenate([[1, 69999], rng.choice(np.arange(2, 4000), 28, replace=False)])
    dst = np.concatenate([np.sort(far), rng.integers(0, 48, 200)])
    w = rng.integers(1, 7, src.shape[0]).astype(np.float32)
    return jbuild_csr(70000, src, dst, w, block_size=32, symmetrize=True)


GRAPHS = {
    "csr": lambda: jrmat_graph(256, 2048, weighted=True, seed=3, block_size=32),
    "compressed": lambda: jcompress(jrmat_graph(256, 2048, weighted=True, seed=3,
                                                block_size=32)),
    "wide": lambda: jcompress(_wide_graph()),
}


def _relax(xs, w):
    return xs + w.astype(xs.dtype) if hasattr(w, "astype") else xs + w.to(xs.dtype)


def _inputs(jg, seed, density):
    rng = np.random.default_rng(seed)
    n = jg.n
    frontier = rng.random(n) < density
    frontier[: 2] = True
    ids = np.arange(n, dtype=np.int32)
    xf = rng.random(n).astype(np.float32)
    mask = rng.random(jg.num_blocks * jg.block_size) < 0.7
    return frontier, ids, xf, mask


def test_wide_graph_holds_exceptions():
    g = port_graph(GRAPHS["wide"]())
    assert g.n_exceptions > 0 and not exception_dense(g)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("mode", MODES)
def test_edgemap_reduce_min_and_sum(graph, mode):
    jg = GRAPHS[graph]()
    g = port_graph(jg)
    frontier, ids, xf, mask = _inputs(jg, 0, 0.05)
    jf, tf = jnp.asarray(frontier), torch.from_numpy(frontier)
    for monoid, x, kw in (
        ("min", ids, {}),
        ("min", ids, {"map_fn": _relax, "edge_active": mask}),
        ("sum", xf, {}),
    ):
        jkw = dict(kw, edge_active=jnp.asarray(mask)) if "edge_active" in kw else kw
        tkw = dict(kw, edge_active=torch.from_numpy(mask)) if "edge_active" in kw else kw
        want, wt = jreduce(jg, jf, jnp.asarray(x), monoid=monoid, mode=mode, **jkw)
        got, gt = edgemap_reduce(g, tf, torch.from_numpy(x), monoid=monoid, mode=mode, **tkw)
        np.testing.assert_array_equal(to_np(gt), np.asarray(wt))
        if monoid == "min":
            np.testing.assert_array_equal(to_np(got), np.asarray(want))
        else:
            np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=SUM_RTOL)


@pytest.mark.parametrize("density", [0.02, 0.9])
def test_auto_takes_both_branches(density):
    jg = GRAPHS["compressed"]()
    g = port_graph(jg)
    frontier, ids, _, _ = _inputs(jg, 1, density)
    want, wt = jreduce(jg, jnp.asarray(frontier), jnp.asarray(ids), mode="auto")
    got, gt = edgemap_reduce(g, torch.from_numpy(frontier), torch.from_numpy(ids), mode="auto")
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(gt), np.asarray(wt))


@pytest.mark.parametrize("graph", ["csr", "wide"])
@pytest.mark.parametrize("mode", MODES)
def test_edgemap_reduce_batched_with_map_lanes(graph, mode):
    jg = GRAPHS[graph]()
    g = port_graph(jg)
    B = 3
    rng = np.random.default_rng(4)
    frontiers = rng.random((B, jg.n)) < 0.05
    frontiers[:, 0] = True
    xs = np.tile(np.arange(jg.n, dtype=np.int32), (B, 1))
    lanes = np.array([True, False, True])
    want, wt = jreduce_batched(jg, jnp.asarray(frontiers), jnp.asarray(xs), monoid="min",
                               map_fn=_relax, mode=mode, map_lanes=jnp.asarray(lanes))
    got, gt = edgemap_reduce_batched(
        g, torch.from_numpy(frontiers), torch.from_numpy(xs), monoid="min",
        map_fn=_relax, mode=mode, map_lanes=torch.from_numpy(lanes),
    )
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(gt), np.asarray(wt))

    xf = rng.random((B, jg.n)).astype(np.float32)
    want, _ = jreduce_batched(jg, jnp.asarray(frontiers), jnp.asarray(xf), monoid="sum",
                              mode=mode)
    got, _ = edgemap_reduce_batched(g, torch.from_numpy(frontiers), torch.from_numpy(xf),
                                    monoid="sum", mode=mode)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=SUM_RTOL)


def test_plan_routes_and_keys():
    jg = GRAPHS["compressed"]()
    g = port_graph(jg)
    plan = make_plan(g, strategy="sparse_streamed", tuning=None)
    jplan = jmake_plan(jg, strategy="sparse_streamed", tuning=None)
    assert plan.backend == jplan.backend == "compressed"
    assert plan.route == "torch" and plan.tuning_key[-1] == "torch"
    assert (plan.chunk_blocks, plan.dense_frac) == (jplan.chunk_blocks, jplan.dense_frac)
    frontier, ids, _, _ = _inputs(jg, 2, 0.1)
    want, _ = jreduce(jg, jnp.asarray(frontier), jnp.asarray(ids), plan=jplan)
    got, _ = edgemap_reduce(g, torch.from_numpy(frontier), torch.from_numpy(ids), plan=plan)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    # a mesh is a ShardMesh (core.mesh.make_mesh); anything else is refused
    with pytest.raises(TypeError, match="ShardMesh"):
        make_plan(g, mesh=object())


def test_edge_map_next_frontier():
    g = port_graph(GRAPHS["csr"]())
    x = torch.full((g.n,), 2**31 - 1, dtype=torch.int32)
    x[0] = 0
    new_x, nxt = edge_map(g, from_indices(g.n, [0], "cpu"), x, mode="sparse")
    nbrs = g.block_dst[g.block_src == 0].reshape(-1)
    nbrs = nbrs[nbrs < g.n]
    assert set(torch.nonzero(nxt.mask).reshape(-1).tolist()) == set(nbrs.tolist())
    assert (new_x[nbrs.long()] == 0).all()
