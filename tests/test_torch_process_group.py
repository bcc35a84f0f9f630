"""Port parity for the graph engine across processes: one shard a rank on a
``ProcessMesh``, the combine on ``torch.distributed`` (gloo, on the CPU).

Each mesh shape is one spawn (``multiprocessing``'s spawn context, ``file://``
init under ``tmp_path``): its ranks run BFS, wBFS, ``wbfs_batched``,
PageRank (12 iterations), k-core and ``tests/test_torch_sharding.py``'s
filtered min loop, with ``pipeline_rounds`` off and on, on graphs built in
the JAX package and carried over as numpy arrays (``tests/process_group_ranks.py``
is the rank side, which imports no JAX).  Rank 0 is held to the JAX
package's single-device results (integer and min results bit for bit,
PageRank within ``SUM_ATOL``), every rank to rank 0 exactly, and each rank's
local shard to shard ``rank`` of the in-process split, bit for bit.  The
three spawns start together; a rank that has not ended within
``SPAWN_LIMIT_S`` is killed and the tests fail.
"""
import multiprocessing
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.algorithms as J
from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import edgemap_reduce as jedgemap_reduce
from repro.core import make_filter as jmake_filter
from repro.data import rmat_graph as jrmat_graph
from repro_torch.core import ProcessMesh, make_plan, make_process_mesh
from process_group_ranks import rank_main
from torch_parity import port_graph, reference_arrays, to_np

SUM_ATOL = 1e-5      # float32 sums combined in another order (tests/test_torch_sharding.py)
SUM_RTOL = 1e-6
PR_ATOL = 1e-5       # PageRank, as tests/test_torch_sharding.py holds it
SPAWN_LIMIT_S = 120  # ranks still running after this are killed: a hung rank fails
MESHES = {
    "(2,) flat": ((2,), ("data",), "flat"),
    "(4,) flat": ((4,), ("data",), "flat"),
    "(2, 2) hierarchical": ((2, 2), ("pod", "data"), "hierarchical"),
}
ALGORITHMS = ("bfs", "wbfs", "wbfs_batched", "pagerank", "kcore", "filtered_min")


def _exception_graph():
    """n = 70,000 with wide gaps: exception rows over 3 sources (the graph
    of ``tests/test_torch_sharding.py``)."""
    n = 70000
    src = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 3], np.int64)
    dst = np.array([1, 2, 66000, 66001, 69998, 69999, 3, 69000, 69500, 68000], np.int64)
    return jbuild_csr(n, src, dst, block_size=32)


def _rmat():
    return jrmat_graph(192, 768, weighted=True, seed=17, block_size=32)


GRAPHS = {
    "rmat csr": _rmat,
    "rmat compressed": lambda: jcompress(_rmat()),
    "exceptions compressed": lambda: jcompress(_exception_graph()),
}


def _jax_filtered_min(jg, bits):
    """The filtered min loop on the JAX package, one ``edgemap_reduce`` a round."""
    x = jnp.arange(jg.n, dtype=jnp.int32)
    fr = jnp.ones(jg.n, bool)
    r = 0
    while r < 50 and bool(fr.any()):
        out, t = jedgemap_reduce(jg, fr, x, monoid="min", mode="sparse", edge_active=bits)
        fr = t & (out < x)
        x = jnp.minimum(x, out)
        r += 1
    return [np.asarray(r), np.asarray(x)]


def _jax_results(jg, bits):
    return {
        "bfs": [np.asarray(a) for a in J.bfs(jg, 3)],
        "wbfs": [np.asarray(J.wbfs(jg, 3))],
        "wbfs_batched": [np.asarray(J.wbfs_batched(jg, jnp.asarray([0, 5, 9])))],
        "pagerank": [np.asarray(J.pagerank(jg, max_iters=12)[0])],
        "kcore": [np.asarray(J.kcore(jg))],
        "filtered_min": _jax_filtered_min(jg, bits),
    }


@pytest.fixture(scope="module")
def built():
    """name -> (JAX graph, its filter's words, the rank payload)."""
    out = {}
    for name, make in GRAPHS.items():
        jg = make()
        bits = jmake_filter(jg).bits
        out[name] = (jg, bits, reference_arrays(jg) + (np.asarray(bits).view(np.int32),))
    return out


def _distributed_inputs(n):
    rng = np.random.default_rng(6)
    x = rng.random(n).astype(np.float32)
    xi = rng.integers(0, 1000, n).astype(np.int32)
    fr = rng.random(n) < 0.3
    return x, xi, fr


def start(tmp_path: pathlib.Path, shape, names, reduce_mode, payload, checks) -> list:
    """Start ``rank_main`` in ``prod(shape)`` spawned processes."""
    world = int(np.prod(shape))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, str(tmp_path / "init"), shape, names,
                                                  reduce_mode, payload, str(tmp_path), checks))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def finish(spawns: dict, limit_s: float) -> dict:
    """Wait for every spawn of ``spawns`` (name -> (tmp_path, procs)) at most
    ``limit_s`` in all, kill what still runs, and return each spawn's rank
    results, or fail with the first rank's traceback or the hung ranks."""
    deadline = time.monotonic() + limit_s
    try:
        for _, procs in spawns.values():
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        hung = {name: [r for r, p in enumerate(procs) if p.is_alive()]
                for name, (_, procs) in spawns.items()}
    finally:
        for _, procs in spawns.values():
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    out = {}
    for name, (tmp, procs) in spawns.items():
        errs = sorted(tmp.glob("rank*.err"))
        assert not errs, f"{name}: {errs[0].read_text()}"
        assert not hung[name], f"{name}: ranks {hung[name]} still running after {limit_s} s"
        assert all(p.exitcode == 0 for p in procs), (name, [p.exitcode for p in procs])
        out[name] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                     for r in range(len(procs))]
    return out


@pytest.fixture(scope="module")
def spawned(built, tmp_path_factory):
    """Every mesh of ``MESHES``, one spawn each, all started at once; the
    JAX package's single-device results are computed while they run.
    Returns (mesh name -> rank results, graph name -> (JAX graph, JAX
    results))."""
    payload = {name: p for name, (_, _, p) in built.items()}
    rmat = built["rmat csr"][0]
    checks = {"errors": True, "distributed": _distributed_inputs(rmat.n) + (
        (1.0 / np.maximum(np.asarray(rmat.degrees), 1)).astype(np.float32),)}
    spawns = {}
    for name, (shape, names, reduce_mode) in MESHES.items():
        tmp = tmp_path_factory.mktemp(name.replace(" ", "_").replace(",", ""))
        spawns[name] = (tmp, start(tmp, shape, names, reduce_mode, payload, checks))
    try:
        want = {name: (jg, _jax_results(jg, bits)) for name, (jg, bits, _) in built.items()}
    finally:
        ranks = finish(spawns, SPAWN_LIMIT_S)
    return ranks, want


@pytest.fixture
def graphs(spawned):
    """graph name -> (JAX graph, JAX single-device results)."""
    return spawned[1]


@pytest.fixture(params=list(MESHES))
def ranks(request, spawned):
    """(mesh name, every rank's results) of one spawn."""
    return request.param, spawned[0][request.param]


@pytest.mark.parametrize("pipelined", ["sequential", "pipelined"])
@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_rank0_equals_jax_single_device(ranks, graphs, algorithm, graph, pipelined):
    """Rank 0's result against JAX's one device: PageRank within
    ``SUM_ATOL``, the rest bit for bit; ``pipeline_rounds`` changes nothing."""
    _, res = ranks
    got = res[0]["graphs"][graph][pipelined][algorithm]
    want = graphs[graph][1][algorithm]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if algorithm == "pagerank":
            np.testing.assert_allclose(a, b, rtol=0, atol=PR_ATOL)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_every_rank_agrees_and_holds_its_own_shard(ranks, graphs, graph):
    """Every rank's results equal rank 0's exactly; each rank holds one
    shard, shard ``rank`` of the in-process split, bit for bit, and its
    filter row alone."""
    name, res = ranks
    world = len(res)
    want = port_graph(graphs[graph][0]).shard(world)
    for r, rr in enumerate(res):
        one = rr["graphs"][graph]
        assert (one["shard_index"], one["num_shards"], one["local_shards"]) == (r, world, 1)
        assert one["active_rows"][0] == r and one["active_rows"][1][0] == 1
        assert f"rank={r} gloo" in one["describe"]
        ref = want[r]
        assert set(one["shard"]) == {k for k, v in vars(ref).items()
                                     if isinstance(v, torch.Tensor)}
        for field, arr in one["shard"].items():
            np.testing.assert_array_equal(arr, to_np(getattr(ref, field)), err_msg=field)
        for mode in ("sequential", "pipelined"):
            for alg in ALGORITHMS:
                for a, b in zip(rr["graphs"][graph][mode][alg],
                                res[0]["graphs"][graph]["sequential"][alg]):
                    np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {mode} {alg}")


def test_distributed_helpers_on_a_process_mesh(ranks, graphs):
    """``distributed_vertex_reduce`` / ``distributed_pagerank_step`` (the
    mesh's reduce mode), the bfloat16 combine and ``distributed_frontier_min``
    against the JAX package's dense weighted edgeMap on one device."""
    _, res = ranks
    jg = graphs["rmat csr"][0]
    x, xi, fr = _distributed_inputs(jg.n)
    inv = (1.0 / np.maximum(np.asarray(jg.degrees), 1)).astype(np.float32)
    ones = jnp.ones(jg.n, bool)
    weighted = lambda xs, w: xs * w  # noqa: E731
    s = np.asarray(jedgemap_reduce(jg, ones, jnp.asarray(x), monoid="sum", map_fn=weighted,
                                   mode="dense")[0])
    sp = np.asarray(jedgemap_reduce(jg, ones, jnp.asarray(x * inv), monoid="sum",
                                    map_fn=weighted, mode="dense")[0])
    mn = np.asarray(jedgemap_reduce(jg, jnp.asarray(fr), jnp.asarray(xi), monoid="min",
                                    mode="dense")[0])
    for rr in res:
        d = rr["distributed"]
        np.testing.assert_allclose(d["reduce"], s, rtol=SUM_RTOL, atol=SUM_ATOL)
        np.testing.assert_allclose(d["pagerank"], (1.0 - 0.85) / jg.n + 0.85 * sp,
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
        assert d["bf16"].dtype == np.float32
        # each shard sum rounds to bfloat16 (8 bits) before the combine
        np.testing.assert_allclose(d["bf16"], s, rtol=2**-7, atol=0)
        np.testing.assert_array_equal(d["min"], mn)
        np.testing.assert_array_equal(d["reduce"], res[0]["distributed"]["reduce"])


def test_process_mesh_errors(ranks):
    """In every rank: a world size that does not fit the mesh, a
    ShardedGraph for another shard count, one prepared in one process, and
    ranks of an NCCL group on one device (the store check) all raise."""
    _, res = ranks
    k = len(res)
    for r, rr in enumerate(res):
        e = rr["errors"]
        assert e["world size"].startswith("ValueError"), e["world size"]
        assert f"needs {k + 1} ranks, the group has {k}" in e["world size"]
        assert f"prepared for {k + 1} shards, plan has {k}" in e["other shard count"]
        assert f"graph holds shard None, this rank's is {r}" in e["in-process graph"]
        assert "share the device cpu" in e["duplicate device"] and "NCCL" in e["duplicate device"]


def test_no_process_group_raises():
    """Without an initialised group there is no process mesh."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        make_process_mesh((2,), ("data",), device="cpu")
    with pytest.raises(TypeError, match="ProcessMesh"):
        make_plan(None, mesh=(2,))


def test_process_mesh_positions():
    """Row-major coordinates and the shard a rank holds over a subset of
    axes, on a mesh built without a group (no collective is reached)."""
    m = ProcessMesh(shape=(2, 3), axis_names=("pod", "data"), rank=4,
                    device=torch.device("cpu"), backend="gloo")
    assert m.coords == (1, 1) and m.size == 6
    assert m.shard_index(("pod", "data")) == 4
    assert m.shard_index(("data",)) == 1 and m.shard_index(("pod",)) == 1
    assert m.shard_index(("data", "pod")) == 1 * 2 + 1
