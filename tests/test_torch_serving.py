"""Port parity for the serving engine.

The same request stream goes to the JAX package's ``QueryEngine`` and to
the port's, on the same graph and strategy.  BFS parents and levels and
wBFS distances must be identical; PageRank iterations agree within rtol
1e-5 (float sums in another order).  ``stats``, occupancy, the padded batch
widths, the PSAM charges and the cache-miss counts (the JAX engine's
retrace counts) must be equal.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import compress as jcompress
from repro.core import make_plan as jmake_plan
from repro.data import rmat_graph as jrmat_graph
from repro.obs import noop_registry as jnoop_registry
from repro.serving import QueryEngine as JQueryEngine
from repro_torch.core import make_plan
from repro_torch.obs import noop_registry
from repro_torch.serving import QueryEngine
from torch_parity import port_graph, to_np

PR_RTOL = 1e-5  # one PageRank iteration: float sums in another order


def _requests(n):
    rng = np.random.default_rng(7)
    pr = rng.random(n).astype(np.float32)
    pr /= pr.sum()
    reqs = [("bfs", {"src": int(s)}) for s in rng.integers(0, n, 5)]
    reqs += [("wbfs", {"src": int(s)}) for s in rng.integers(0, n, 3)]
    reqs += [("bfs", {"src": 9, "mode": "sparse"})]
    reqs += [("pagerank_iteration", {"pr": pr}), ("pagerank_iteration", {"pr": pr[::-1].copy()})]
    return reqs


def _engines(compressed, strategy):
    jg = jrmat_graph(256, 2048, weighted=True, seed=13, block_size=32)
    jg = jcompress(jg) if compressed else jg
    g = port_graph(jg)
    jeng = JQueryEngine(jg, plan=jmake_plan(jg, strategy=strategy, tuning=None),
                        max_batch=4, registry=jnoop_registry())
    eng = QueryEngine(g, plan=make_plan(g, strategy=strategy, tuning=None), max_batch=4,
                      registry=noop_registry())
    return jeng, eng, g.n


def _assert_same_result(op, got, want):
    if op == "bfs":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    elif op == "wbfs":
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    else:
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=PR_RTOL)


def _miss_counts(trace_counts):
    """{(op, B, scalars): misses}, dropping the engine-specific key parts."""
    return {k[-3:]: v for k, v in trace_counts.items()}


@pytest.mark.parametrize("compressed,strategy",
                         [(False, "auto"), (True, "auto"), (True, "sparse_streamed")])
def test_engine_matches_jax_engine(compressed, strategy):
    jeng, eng, n = _engines(compressed, strategy)
    reqs = _requests(n)
    want = jeng.serve(reqs)
    got = eng.serve(reqs)
    for (op, _), a, b in zip(reqs, got, want):
        _assert_same_result(op, a, b)
    assert eng.stats == jeng.stats
    assert eng.stats["padded"] > 0  # 3 wbfs pad to B=4, 1 bfs to B=1, 2 pr to B=2
    assert eng.occupancy == jeng.occupancy
    assert (eng.cost.large_reads, eng.cost.small_ops, eng.cost.large_writes) == (
        jeng.cost.large_reads, jeng.cost.small_ops, jeng.cost.large_writes)
    assert _miss_counts(eng.trace_counts) == _miss_counts(jeng.trace_counts)

    # the same shapes again: every bucket hits the cache, as the JAX engine
    # serves them with no retrace
    misses = dict(eng.trace_counts)
    again = eng.serve(reqs)
    jeng.serve(reqs)
    assert eng.trace_counts == misses
    assert _miss_counts(eng.trace_counts) == _miss_counts(jeng.trace_counts)
    for (op, _), a, b in zip(reqs, again, got):
        _assert_same_result(op, a, [to_np(t) for t in b] if op == "bfs" else to_np(b))


def test_engine_pads_to_powers_of_two_and_rejects_unported_ops():
    jeng, eng, n = _engines(True, "sparse_streamed")
    handles = [eng.submit("bfs", src=s) for s in range(5)]
    res = eng.flush()
    assert set(res) == set(handles)
    assert eng.stats == {"submitted": 5, "served": 5, "batches": 2, "lanes": 5, "padded": 0}
    eng.reset_stats()
    eng.serve([("bfs", {"src": s}) for s in range(3)])
    assert eng.stats["lanes"] == 4 and eng.stats["padded"] == 1
    assert eng.occupancy == 0.75
    # an op neither package serves (both serve bfs, wbfs, ppr and
    # pagerank_iteration)
    for engine in (eng, jeng):
        with pytest.raises(ValueError, match="unknown op"):
            engine.submit("bellman_ford", src=0)
