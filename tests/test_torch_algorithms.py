"""Port parity for BFS, wBFS and PageRank.

BFS parents and levels and wBFS distances must be identical to the JAX
package's on the same graph and plan, on both storage backends and on a
``sparse_streamed`` plan.  PageRank sums floats in another order, so one
iteration agrees within rtol 1e-5, and a fixed number of iterations
(``eps=0``) within atol 1e-6 on scores of order 1/n.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.algorithms import bfs as jbfs
from repro.algorithms import bfs_batched as jbfs_batched
from repro.algorithms import pagerank as jpagerank
from repro.algorithms import pagerank_iteration as jpagerank_iteration
from repro.algorithms import wbfs as jwbfs
from repro.algorithms import wbfs_batched as jwbfs_batched
from repro.core import compress as jcompress
from repro.core import make_plan as jmake_plan
from repro.data import rmat_graph as jrmat_graph
from repro_torch.algorithms import (
    bfs,
    bfs_batched,
    pagerank,
    pagerank_iteration,
    pagerank_iteration_batched,
    wbfs,
    wbfs_batched,
)
from repro_torch.core import make_plan
from torch_parity import port_graph, to_np

PR_RTOL = 1e-5   # one iteration: float sums in another order
PR_ATOL = 1e-6   # 20 iterations, scores ~1/n = 4e-3

STRATEGIES = ("auto", "sparse_streamed")


def _graphs(compressed):
    jg = jrmat_graph(256, 2048, weighted=True, seed=11, block_size=32)
    jg = jcompress(jg) if compressed else jg
    return jg, port_graph(jg)


def _plans(jg, g, strategy):
    return jmake_plan(jg, strategy=strategy, tuning=None), make_plan(g, strategy=strategy, tuning=None)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_bfs_single_and_batched(compressed, strategy):
    jg, g = _graphs(compressed)
    jplan, plan = _plans(jg, g, strategy)
    for src in (0, 17):
        wp, wl = jbfs(jg, src, plan=jplan)
        gp, gl = bfs(g, src, plan=plan)
        np.testing.assert_array_equal(to_np(gp), np.asarray(wp))
        np.testing.assert_array_equal(to_np(gl), np.asarray(wl))
    sources = [0, 5, 200]
    wp, wl = jbfs_batched(jg, jnp.asarray(sources, jnp.int32), plan=jplan)
    gp, gl = bfs_batched(g, sources, plan=plan)
    np.testing.assert_array_equal(to_np(gp), np.asarray(wp))
    np.testing.assert_array_equal(to_np(gl), np.asarray(wl))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_wbfs_single_and_batched(compressed, strategy):
    jg, g = _graphs(compressed)
    jplan, plan = _plans(jg, g, strategy)
    np.testing.assert_array_equal(to_np(wbfs(g, 3, plan=plan)),
                                  np.asarray(jwbfs(jg, 3, plan=jplan)))
    sources = [3, 99]
    np.testing.assert_array_equal(
        to_np(wbfs_batched(g, sources, plan=plan)),
        np.asarray(jwbfs_batched(jg, jnp.asarray(sources, jnp.int32), plan=jplan)),
    )


def test_bfs_root_masks_and_unplanned_modes():
    jg, g = _graphs(True)
    roots = np.zeros((2, g.n), bool)
    roots[0, [1, 2]] = True
    roots[1, 40] = True
    wp, wl = jbfs_batched(jg, jnp.asarray(roots), mode="sparse")
    gp, gl = bfs_batched(g, torch.from_numpy(roots), mode="sparse")
    np.testing.assert_array_equal(to_np(gp), np.asarray(wp))
    np.testing.assert_array_equal(to_np(gl), np.asarray(wl))
    with pytest.raises(ValueError):
        bfs_batched(g, torch.zeros(3, dtype=torch.bool))


@pytest.mark.parametrize("compressed", [False, True])
def test_pagerank_iteration_and_fixed_iterations(compressed):
    jg, g = _graphs(compressed)
    pr = np.random.default_rng(0).random(g.n).astype(np.float32)
    pr /= pr.sum()
    np.testing.assert_allclose(
        to_np(pagerank_iteration(g, torch.from_numpy(pr))),
        np.asarray(jpagerank_iteration(jg, jnp.asarray(pr))), rtol=PR_RTOL,
    )
    prs = np.stack([pr, np.roll(pr, 3)])
    batched = to_np(pagerank_iteration_batched(g, torch.from_numpy(prs)))
    for i in range(2):
        np.testing.assert_allclose(
            batched[i], np.asarray(jpagerank_iteration(jg, jnp.asarray(prs[i]))),
            rtol=PR_RTOL,
        )
    want, wit = jpagerank(jg, eps=0.0, max_iters=20)
    got, it = pagerank(g, eps=0.0, max_iters=20)
    assert it == int(wit) == 20
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=PR_ATOL, rtol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-4
