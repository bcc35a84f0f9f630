"""Port parity for sharded execution: the shard split, the sharded edgeMap
executor, the round loop, and the serving and distributed layers
on a mesh plan; also the repairs and the core surface that came with them.

Graphs are built in the JAX package and carried over as numpy arrays.  The
port's meshes are ``[cpu] * k`` (``make_mesh(shape, names, devices=...)``),
and the port on a mesh is held to the JAX package's single-device results,
as ``tests/test_plan.py`` holds the JAX package's own mesh: min, max and or
results bit for bit, sums within ``SUM_ATOL``.  The ``shard`` arrays are
held to the JAX package's ``shard`` leaf for leaf, bit for bit.  The JAX
results are computed once per graph.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.algorithms as J
import repro_torch.algorithms as T
import repro_torch.core.edgemap as port_edgemap
from repro.compat import make_mesh as jmake_mesh
from repro.core import Buckets as JBuckets
from repro.core import PSAMCost as JPSAMCost
from repro.core import build_csr as jbuild_csr
from repro.core import compact_live_blocks as jcompact_live_blocks
from repro.core import compress as jcompress
from repro.core import edgemap_reduce as jedgemap_reduce
from repro.core import edgemap_reduce_batched as jedgemap_reduce_batched
from repro.core import edgemap_sum_compressed as jedgemap_sum_compressed
from repro.core import from_indices as jfrom_indices
from repro.core import from_mask as jfrom_mask
from repro.core import make_filter as jmake_filter
from repro.core import sharded_graph_spec as jsharded_graph_spec
from repro.data import rmat_graph as jrmat_graph
from repro.distributed import engine as jdist
from repro_torch.core import (
    Buckets,
    CompressedCSR,
    CSRGraph,
    GraphBackend,
    PSAMCost,
    ShardedEdgeActive,
    ShardedGraph,
    compact_live_blocks,
    edgemap_reduce,
    edgemap_reduce_batched,
    edgemap_sum_compressed,
    empty,
    filter_from_reference_arrays,
    from_indices,
    from_mask,
    full,
    make_filter,
    make_mesh,
    make_plan,
    round_loop,
    shard_edge_active,
    sharded_graph_spec,
)
from repro_torch.core.convert import FILTER_FIELDS, FILTER_META
from repro_torch.distributed import (
    distributed_frontier_min,
    distributed_pagerank_step,
    distributed_vertex_reduce,
    prepare_sharded,
    shard_blocks_for_mesh,
)
from repro_torch.obs import Registry, noop_registry
from repro_torch.serving import QueryEngine, ServiceConfig, ServingService
from repro_torch.tuning import DEFAULT_EST_ROUNDS, calibrate
from torch_parity import port_graph, to_np, words_u32

CPU = torch.device("cpu")
SUM_ATOL = 1e-5     # float32 sums: per-shard partial sums combined in another order
SUM_RTOL = 1e-6     # ... relative, for weighted sums in the tens to hundreds
PR_ATOL = 1e-5      # PageRank and PPR scores, as tests/test_plan.py holds them
BC_ATOL = 1e-4      # betweenness: sums of quotients in another order
BF16_ATOL = 2e-3    # PageRank combined in bfloat16 (8 mantissa bits) vs float32
MESHES = {
    "(1,)": ((1,), ("data",)),
    "(2,)": ((2,), ("data",)),
    "(4,)": ((4,), ("data",)),
    "(2, 2)": ((2, 2), ("pod", "data")),
}
MODES = ("dense", "sparse", "sparse_streamed", "auto")
_CACHE = {}


def _mesh(name):
    shape, names = MESHES[name]
    return make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _exception_graph():
    """n = 70,000 with wide gaps: a non-empty exception list over 3 sources
    (the graph of ``tests/test_plan.py``'s compressed shard test)."""
    n = 70000
    src = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 3], np.int64)
    dst = np.array([1, 2, 66000, 66001, 69998, 69999, 3, 69000, 69500, 68000], np.int64)
    return jbuild_csr(n, src, dst, block_size=32)


GRAPHS = {
    "rmat": lambda: jrmat_graph(192, 768, weighted=True, seed=17, block_size=32),
    "exceptions": _exception_graph,
}


def _graph(name, compressed):
    """(JAX graph, the port's copy) for a graph of ``GRAPHS``."""
    def make():
        jg = GRAPHS[name]()
        jg = jcompress(jg) if compressed else jg
        return jg, port_graph(jg)
    return _cached(("graph", name, compressed), make)


def _leaves(g):
    """Every array field of a port or JAX graph/filter as numpy, and its
    static fields, keyed by name (uint16/uint32 as the port's bit views)."""
    arrays, meta = {}, {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if v is None or isinstance(v, (bool, int)):
            meta[f.name] = v
        else:
            a = to_np(v)
            if a.dtype == np.uint16:
                a = a.view(np.int16)
            elif a.dtype == np.uint32:
                a = a.view(np.int32)
            arrays[f.name] = a
    return arrays, meta


def _same_leaves(got, want):
    ga, gm = _leaves(got)
    wa, wm = _leaves(want)
    assert gm == wm
    assert set(ga) == set(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype, k
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)


# ----------------------------------------------------------------------
# shard(): the split, leaf for leaf
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["csr", "compressed", "compressed exceptions", "filter"])
def test_shard_equals_jax(kind, k):
    name = "exceptions" if kind == "compressed exceptions" else "rmat"
    jg, g = _graph(name, kind != "csr")
    if kind == "filter":
        jf = jmake_filter(jg)
        f = filter_from_reference_arrays(
            {f: np.asarray(getattr(jf, f)) for f in FILTER_FIELDS},
            {m: getattr(jf, m) for m in FILTER_META}, "cpu")
        want, got = jf.shard(k), f.shard(k)
    else:
        want, got = jg.shard(k), g.shard(k)
    if kind == "compressed exceptions":
        assert g.n_exceptions > 0 and g.num_blocks % 3 != 0
    assert len(got) == len(want) == k
    for a, b in zip(got, want):
        _same_leaves(a, b)


def test_shard_keeps_views_inside_the_graph():
    """Shards inside the block range share the graph's storage; only the one
    reaching the padding is a new tensor."""
    _, g = _graph("rmat", False)
    k = 4 if g.num_blocks % 4 else 3
    assert g.num_blocks % k
    shards = g.shard(k)
    base = g.edge_dst.untyped_storage().data_ptr()
    for s in shards[:-1]:
        assert s.edge_dst.untyped_storage().data_ptr() == base
    assert shards[-1].edge_dst.untyped_storage().data_ptr() != base
    assert isinstance(g, GraphBackend) and all(isinstance(s, GraphBackend) for s in shards)


# ----------------------------------------------------------------------
# compact_live_blocks / shard_edge_active / sharded_graph_spec
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compressed", [False, True])
def test_compact_live_blocks_equals_jax(compressed):
    jg, g = _graph("exceptions" if compressed else "rmat", compressed)
    rng = np.random.default_rng(5)
    slots = g.num_blocks * g.block_size
    mask = to_np(g.edge_valid) & (rng.random(slots) < 0.3)
    # kill whole blocks so the compaction drops some, exception blocks too
    mask.reshape(g.num_blocks, -1)[::2] = False
    jl, jw, jids = jcompact_live_blocks(jg, jnp.asarray(mask))
    gl, w, ids = compact_live_blocks(g, torch.from_numpy(mask))
    _same_leaves(gl, jl)
    np.testing.assert_array_equal(words_u32(w), np.asarray(jw))
    np.testing.assert_array_equal(to_np(ids), np.asarray(jids))
    assert to_np(ids).dtype == np.int32


def test_shard_edge_active_rejects_foreign_filter():
    """As the JAX package's own test: a filter of a smaller graph raises, the
    genuine one shards, and a known block count is checked exactly."""
    _, g = _graph("rmat", False)
    small = port_graph(jrmat_graph(16, 32, seed=3, block_size=32))
    assert small.num_blocks < g.num_blocks
    per = -(-g.num_blocks // 4)
    with pytest.raises(ValueError, match="different graph"):
        shard_edge_active(make_filter(small), block_size=32, blocks_per_shard=per,
                          num_shards=4)
    sea = shard_edge_active(make_filter(g), block_size=32, blocks_per_shard=per,
                            num_shards=4)
    assert tuple(sea.words.shape) == (4, per, 1)
    short = torch.zeros((10, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="different graph"):
        shard_edge_active(short, block_size=32, blocks_per_shard=3, num_shards=4,
                          num_blocks=11)


def test_prepare_compact_live_equals_jax_words():
    """``prepare(..., compact_live=True)`` on a (2,) mesh: the shard rows are
    JAX's ``compact_live_blocks`` rows split, ``live_ids`` padded with the
    original block count; a filtered round equals the uncompacted one."""
    jg, g = _graph("rmat", True)
    rng = np.random.default_rng(9)
    mask = to_np(g.edge_valid) & (rng.random(g.num_blocks * 32) < 0.2)
    mask.reshape(g.num_blocks, -1)[1::3] = False
    _, jw, jids = jcompact_live_blocks(jg, jnp.asarray(mask))
    plan = make_plan(g, mesh=_mesh("(2,)"), tuning=None)
    gs, sea = plan.prepare(g, edge_active=torch.from_numpy(mask), compact_live=True)
    k = jids.shape[0]
    per = gs.blocks_per_shard
    assert per == -(-k // 2) and isinstance(sea, ShardedEdgeActive)
    lid = to_np(sea.live_ids).reshape(-1)
    np.testing.assert_array_equal(lid[:k], np.asarray(jids))
    assert np.all(lid[k:] == g.num_blocks)
    words = words_u32(sea.words).reshape(-1, 1)
    np.testing.assert_array_equal(words[:k], np.asarray(jw))
    x = torch.arange(g.n, dtype=torch.int32)
    fr = torch.ones(g.n, dtype=torch.bool)
    want = jedgemap_reduce(jg, jnp.ones(g.n, bool), jnp.asarray(to_np(x)), monoid="min",
                           edge_active=jnp.asarray(mask), mode="dense")
    got = edgemap_reduce(gs, fr, x, monoid="min", edge_active=sea, plan=plan)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    with pytest.raises(ValueError, match="before the shard split"):
        plan.prepare(gs, edge_active=sea, compact_live=True)


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_graph_spec_matches_jax(weighted):
    want = jsharded_graph_spec(1000, 37, 32, 4, weighted)
    got = sharded_graph_spec(1000, 37, 32, 4, weighted)
    assert (got.num_shards, got.orig_num_blocks) == (want.num_shards, want.orig_num_blocks)
    assert len(got.shards) == 4 and got.blocks_per_shard == want.blocks_per_shard
    for s in got.shards:
        assert s.device.type == "meta"
        for f in ("offsets", "block_offsets", "block_src", "edge_src", "edge_dst", "edge_w",
                  "degrees"):
            leaf = getattr(want.shards, f)
            assert (4,) + tuple(getattr(s, f).shape) == tuple(leaf.shape), f


# ----------------------------------------------------------------------
# the executor: every strategy and monoid on every mesh
# ----------------------------------------------------------------------
def _inputs(g, monoid):
    rng = np.random.default_rng(3)
    if monoid == "sum":
        x = rng.standard_normal(g.n).astype(np.float32)
    elif monoid == "or":
        x = rng.random(g.n) < 0.5
    else:
        x = rng.integers(-1000, 1000, g.n).astype(np.int32)
    fr = rng.random(g.n) < 0.15
    active = to_np(g.edge_valid) & (rng.random(g.num_blocks * g.block_size) < 0.6)
    return x, fr, active


def _want_single(name, compressed, monoid, filtered):
    jg, g = _graph(name, compressed)

    def run():
        x, fr, active = _inputs(g, monoid)
        out = jedgemap_reduce(jg, jnp.asarray(fr), jnp.asarray(x), monoid=monoid,
                              mode="dense",
                              edge_active=jnp.asarray(active) if filtered else None)
        return tuple(np.asarray(o) for o in out)
    return _cached(("single", name, compressed, monoid, filtered), run)


def _same(got, want, monoid):
    out, touched = (to_np(t) for t in got)
    np.testing.assert_array_equal(touched, want[1])
    assert out.dtype == want[0].dtype
    if monoid == "sum":
        np.testing.assert_allclose(out, want[0], rtol=0, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(out, want[0])


@pytest.mark.parametrize("compressed", [False, True], ids=["csr", "compressed"])
@pytest.mark.parametrize("reduce_mode", ["flat", "hierarchical"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_edgemap_reduce_matches_jax(mesh, reduce_mode, compressed):
    """Single queries, four strategies, four monoids, with and without a
    filter (a raw slot mask and a prepared ``ShardedEdgeActive``)."""
    name = "rmat"
    _, g = _graph(name, compressed)
    plan = make_plan(g, mesh=_mesh(mesh), reduce_mode=reduce_mode, tuning=None)
    gs = plan.prepare(g)
    assert isinstance(gs, ShardedGraph) and gs.num_shards == plan.num_shards
    for monoid in ("min", "max", "or", "sum"):
        x, fr, active = _inputs(g, monoid)
        x, fr, active = (torch.from_numpy(a) for a in (x, fr, active))
        _, sea = plan.prepare(g, edge_active=active)
        for filtered in (False, True):
            want = _want_single(name, compressed, monoid, filtered)
            for ea in ((active, sea) if filtered else (None,)):
                for mode in MODES:
                    got = edgemap_reduce(gs, fr, x, monoid=monoid, mode=mode,
                                         edge_active=ea, plan=plan)
                    _same(got, want, monoid)


def _relax_j(xs, w):
    return jnp.where(xs >= 2**31 - 1 - (1 << 24), 2**31 - 1, xs + w.astype(jnp.int32))


@pytest.mark.parametrize("compressed", [False, True], ids=["csr", "compressed"])
@pytest.mark.parametrize("mesh", ["(2,)", "(2, 2)"])
def test_sharded_batched_matches_jax(mesh, compressed):
    """Batches of 4 through ``edgemap_reduce_batched`` on a mesh: min over
    int32 with wBFS's map on two of the lanes (``map_lanes``), filtered and
    not, every strategy; and a float sum batch, flat and hierarchical."""
    jg, g = _graph("rmat", compressed)
    rng = np.random.default_rng(4)
    B = 4
    x = rng.integers(0, 1000, (B, g.n)).astype(np.int32)
    fr = rng.random((B, g.n)) < 0.1
    lanes = np.array([True, False, True, False])
    active = to_np(g.edge_valid) & (rng.random(g.num_blocks * 32) < 0.7)
    xs = rng.standard_normal((B, g.n)).astype(np.float32)

    def want_fn():
        out = {}
        for filtered in (False, True):
            out[filtered] = [np.asarray(o) for o in jedgemap_reduce_batched(
                jg, jnp.asarray(fr), jnp.asarray(x), monoid="min", map_fn=_relax_j,
                map_lanes=jnp.asarray(lanes), mode="dense",
                edge_active=jnp.asarray(active) if filtered else None)]
        out["sum"] = [np.asarray(o) for o in jedgemap_reduce_batched(
            jg, jnp.asarray(fr), jnp.asarray(xs), monoid="sum", mode="dense")]
        return out
    want = _cached(("batched", compressed), want_fn)
    tx, tfr, tl, ta = (torch.from_numpy(a) for a in (x, fr, lanes, active))
    for rm in ("flat", "hierarchical"):
        plan = make_plan(g, mesh=_mesh(mesh), reduce_mode=rm, tuning=None)
        gs = plan.prepare(g)
        for filtered in (False, True):
            for mode in MODES:
                got = edgemap_reduce_batched(
                    gs, tfr, tx, monoid="min", map_fn=T.traversal._relax, map_lanes=tl,
                    mode=mode, plan=plan, edge_active=ta if filtered else None)
                _same(got, want[filtered], "min")
        got = edgemap_reduce_batched(gs, tfr, torch.from_numpy(xs), monoid="sum",
                                     mode="dense", plan=plan)
        _same(got, want["sum"], "sum")


def test_sharded_calls_counted_and_state_dtype():
    """Each eager sharded call bumps ``sage_sharded_edgemap_calls_total``
    once (and no single-device counter); ``state_dtype`` sums in bfloat16;
    a hierarchical sum over a 3-D state raises."""
    from repro_torch.obs import set_registry

    _, g = _graph("rmat", False)
    reg = Registry()
    prev = set_registry(reg)
    try:
        plan = make_plan(g, mesh=_mesh("(2, 2)"), tuning=None)
        gs = plan.prepare(g)
        fr = torch.ones(g.n, dtype=torch.bool)
        x = torch.rand(g.n)
        edgemap_reduce(gs, fr, x, monoid="sum", mode="dense", plan=plan)
        edgemap_reduce_batched(gs, fr[None], x[None], monoid="sum", mode="dense", plan=plan)
        fam = reg.counter("sage_sharded_edgemap_calls_total", "", labels=("batched",))
        assert fam.value(batched="false") == 1 and fam.value(batched="true") == 1
        assert reg.counter("sage_edgemap_calls_total", "", labels=("mode",)).value() == 0
    finally:
        set_registry(prev)
    want, _ = edgemap_reduce(g, fr, x, monoid="sum", mode="dense")
    bf = make_plan(g, mesh=_mesh("(2, 2)"), state_dtype=torch.bfloat16, tuning=None)
    got, _ = edgemap_reduce(bf.prepare(g), fr, x, monoid="sum", mode="dense", plan=bf)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-2, atol=BF16_ATOL)
    hier = make_plan(g, mesh=_mesh("(2, 2)"), reduce_mode="hierarchical", tuning=None)
    with pytest.raises(NotImplementedError, match="1-D or"):
        edgemap_reduce(hier.prepare(g), fr, torch.rand(g.n, 2, 2), monoid="sum", mode="dense",
                       plan=hier)


# ----------------------------------------------------------------------
# the algorithms on a (4,) plan, against JAX single-device
# ----------------------------------------------------------------------
KEY = jax.random.PRNGKey(0)


def _perm(n):
    return torch.from_numpy(np.array(jax.random.permutation(KEY, jnp.arange(n, dtype=jnp.int32))))


def _sets(n):
    return np.arange(n) % 2 == 0


ALGORITHMS = {
    "bfs": (lambda jg: J.bfs(jg, 0), lambda g, p: T.bfs(g, 0, plan=p), 0),
    "wbfs": (lambda jg: J.wbfs(jg, 0), lambda g, p: T.wbfs(g, 0, plan=p), 0),
    "pagerank": (lambda jg: J.pagerank(jg, max_iters=30)[0],
                 lambda g, p: T.pagerank(g, max_iters=30, plan=p)[0], PR_ATOL),
    "ppr": (lambda jg: J.personalized_pagerank(jg, 0, max_rounds=40),
            lambda g, p: T.personalized_pagerank(g, 0, max_rounds=40, plan=p), PR_ATOL),
    "widest_path": (lambda jg: J.widest_path(jg, 0), lambda g, p: T.widest_path(g, 0, plan=p),
                    0),
    "betweenness": (lambda jg: J.betweenness(jg, 0), lambda g, p: T.betweenness(g, 0, plan=p),
                    BC_ATOL),
    "connectivity": (lambda jg: J.connectivity(jg, use_ldd=False),
                     lambda g, p: T.connectivity(g, use_ldd=False, plan=p), 0),
    "kcore": (lambda jg: J.kcore(jg), lambda g, p: T.kcore(g, plan=p), 0),
    "set_cover": (lambda jg: J.set_cover(jg, jnp.asarray(_sets(jg.n)), KEY),
                  lambda g, p: T.set_cover(g, torch.from_numpy(_sets(g.n)), plan=p,
                                           priorities=_perm(g.n)), 0),
}


def _flat(out):
    if isinstance(out, tuple):
        return [to_np(o) if hasattr(o, "shape") else np.asarray(o) for o in out]
    return [to_np(out)]


@pytest.mark.parametrize("compressed", [False, True], ids=["csr", "compressed"])
@pytest.mark.parametrize("algorithm", list(ALGORITHMS))
def test_algorithms_on_a_mesh_plan_match_jax(algorithm, compressed):
    jfn, fn, atol = ALGORITHMS[algorithm]
    jg, g = _graph("rmat", compressed)
    want = _cached(("alg", algorithm, compressed), lambda: _flat(jfn(jg)))
    plan = make_plan(g, mesh=_mesh("(4,)"), tuning=None)
    got = _flat(fn(g, plan))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# the round loop under pipeline_rounds
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compressed", [False, True], ids=["csr", "compressed"])
@pytest.mark.parametrize("mesh", ["(4,)", "(2, 2)"])
def test_pipelined_round_loop_equals_sequential(mesh, compressed):
    """BFS, wBFS (batched too), PageRank and a filtered min loop: a
    ``pipeline_rounds`` plan (its own ``tuning_key``) runs the sequential
    loop, bit for bit."""
    _, g = _graph("rmat", compressed)
    seq = make_plan(g, mesh=_mesh(mesh), tuning=None)
    pipe = dataclasses.replace(seq, pipeline_rounds=True)
    assert pipe.tuning_key != seq.tuning_key
    gs = seq.prepare(g)
    for fn in (lambda p: T.bfs(gs, 3, plan=p), lambda p: T.wbfs(gs, 3, plan=p),
               lambda p: T.wbfs_batched(gs, [0, 5, 9], plan=p),
               lambda p: T.pagerank(gs, max_iters=12, plan=p)[0]):
        for a, b in zip(_flat(fn(seq)), _flat(fn(pipe))):
            np.testing.assert_array_equal(a, b)
    active = make_filter(g).bits
    x0 = torch.arange(g.n, dtype=torch.int32)

    def loop(p):
        return round_loop(
            gs, (0, x0, torch.ones(g.n, dtype=torch.bool)),
            sweep_inputs=lambda s: (s, s[2], s[1]),
            epilogue=lambda s, out, t: (s[0] + 1, torch.minimum(s[1], out),
                                        t & (out < s[1])),
            cond_fn=lambda s: s[0] < 50 and bool(s[2].any()),
            monoid="min", plan=p, edge_active=active, mode="sparse")
    a, b = loop(seq), loop(pipe)
    want = round_loop(
        g, (0, x0, torch.ones(g.n, dtype=torch.bool)),
        sweep_inputs=lambda s: (s, s[2], s[1]),
        epilogue=lambda s, out, t: (s[0] + 1, torch.minimum(s[1], out), t & (out < s[1])),
        cond_fn=lambda s: s[0] < 50 and bool(s[2].any()),
        monoid="min", edge_active=active, mode="sparse")
    assert a[0] == b[0] == want[0] and torch.equal(a[1], b[1])
    assert torch.equal(want[1], a[1])


# ----------------------------------------------------------------------
# serving on a (2,) plan
# ----------------------------------------------------------------------
def _recording(cost, log):
    """Record every edgeMap charge of ``cost`` as (kind, batch, shards)."""
    batched, sparse = cost.charge_edgemap_batched, cost.charge_edgemap_sparse

    def rec_batched(g, batch, num_shards=1, **kw):
        log.append(("batched", batch, num_shards, None))
        return batched(g, batch, num_shards=num_shards, **kw)

    def rec_sparse(g, live, *, batch=1, num_shards=1, **kw):
        log.append(("sparse", batch, num_shards, live))
        return sparse(g, live, batch=batch, num_shards=num_shards, **kw)

    cost.charge_edgemap_batched, cost.charge_edgemap_sparse = rec_batched, rec_sparse


def _replay(jg, log):
    """The same charges on the JAX package's PSAMCost."""
    c = JPSAMCost()
    for kind, batch, shards, live in log:
        if kind == "batched":
            c.charge_edgemap_batched(jg, batch, num_shards=shards)
        else:
            c.charge_edgemap_sparse(jg, live, batch=batch, num_shards=shards)
    return c


@pytest.mark.parametrize("strategy", ["auto", "sparse_streamed"])
def test_query_engine_on_a_mesh_plan(strategy):
    """12 BFS and 4 wBFS queries through ``QueryEngine`` on a (2,) plan:
    every answer equals JAX single-device's, the cache key carries the mesh,
    and the PSAM charges equal the JAX formula at ``num_shards=2``."""
    from repro.serving import QueryEngine as JQueryEngine

    jg, g = _graph("rmat", True)
    plan = make_plan(g, mesh=_mesh("(2,)"), strategy=strategy, tuning=None)
    eng = QueryEngine(g, plan=plan, registry=noop_registry())
    log = []
    _recording(eng.cost, log)
    reqs = [("bfs", {"src": s}) for s in range(0, 120, 10)] + [
        ("wbfs", {"src": s}) for s in (1, 7, 50, 99)]
    got = eng.serve(reqs)
    jeng = JQueryEngine(jg)
    jlog = []
    _recording(jeng.cost, jlog)
    want = jeng.serve(reqs)
    for (op, _), a, b in zip(reqs, got, want):
        for x, y in zip(_flat(a), _flat(b)):
            np.testing.assert_array_equal(x, y)
    assert all(k[1] == (("data", 2),) for k in eng.trace_counts)
    assert log and all(s == 2 for _, _, s, _ in log)
    jc = _replay(jg, log)
    assert (eng.cost.large_reads, eng.cost.small_ops) == (jc.large_reads, jc.small_ops)
    if strategy == "auto":  # the same drains, charged for one shard by JAX
        assert [e[:2] for e in log] == [e[:2] for e in jlog]


def test_serving_service_on_a_mesh_plan():
    """A mixed BFS/wBFS/PPR stream through ``ServingService`` on a (2,) plan:
    every ticket equals its single-device port run, the cohort key carries
    the mesh, the read quantum is the sharded one, and the cohort charges
    equal the JAX formula at ``num_shards=2``."""
    jg, g = _graph("rmat", True)
    plan = make_plan(g, mesh=_mesh("(2,)"), strategy="sparse_streamed", tuning=None)
    single = make_plan(g, strategy="sparse_streamed", tuning=None)
    svcs = []
    for p in (plan, single):
        svc = ServingService(g, plan=p, config=ServiceConfig(max_batch=8),
                             registry=noop_registry())
        for op, src in [("bfs", 0), ("wbfs", 3), ("bfs", 17), ("ppr", 5), ("wbfs", 40),
                        ("bfs", 77)]:
            svc.submit(op, now=0.0, src=src)
        svcs.append((svc, svc.drain(now=0.5)))
    (svc, done), (one, done1) = svcs
    assert [t.id for t in done] == [t.id for t in done1]
    for t, u in zip(done, done1):
        assert (t.status, t.rounds) == (u.status, u.rounds)
        for a, b in zip(_flat(t.result), _flat(u.result)):
            if t.op == "ppr":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b)
    assert all(k[1] == (("data", 2),) for k in svc.trace_counts)
    assert svc._round_words == plan.edge_read_words_per_round(g) > 0
    jplan_words = JPSAMCost()
    jplan_words.charge_edgemap_planned(jg, num_shards=2)
    assert svc._round_words == jplan_words.large_reads
    assert svc.stats["cohort_rounds"] == one.stats["cohort_rounds"] > 0
    assert svc.stats == one.stats and svc.engine.stats == one.engine.stats


# ----------------------------------------------------------------------
# the distributed helpers, against JAX on a one-device mesh
# ----------------------------------------------------------------------
def _distributed_inputs(g):
    rng = np.random.default_rng(6)
    x = rng.random(g.n).astype(np.float32)
    xi = rng.integers(0, 1000, g.n).astype(np.int32)
    fr = rng.random(g.n) < 0.3
    inv = (1.0 / np.maximum(to_np(g.degrees), 1)).astype(np.float32)
    return x, xi, fr, inv


def _distributed_want():
    """The JAX helpers on a one-device mesh, each jitted once (flat and
    hierarchical coincide on one axis)."""
    jg, g = _graph("rmat", False)
    jm = jmake_mesh((1,), ("data",))
    n = g.n
    x, xi, fr, inv = (jnp.asarray(a) for a in _distributed_inputs(g))
    jgs = jdist.prepare_sharded(jm, jg)
    return {
        "reduce": np.asarray(jax.jit(jdist.distributed_vertex_reduce(jm, n=n))(jgs, x)),
        "pagerank": np.asarray(jax.jit(jdist.distributed_pagerank_step(jm, n=n))(jgs, x, inv)),
        "bf16": np.asarray(jax.jit(jdist.distributed_vertex_reduce(
            jm, n=n, state_dtype=jnp.bfloat16))(jgs, x)),
        "min": np.asarray(jax.jit(jdist.distributed_frontier_min(jm, n=n))(jgs, xi, fr)),
    }


@pytest.mark.parametrize("mesh", ["(1,)", "(4,)", "(2, 2)"])
def test_distributed_helpers_match_jax(mesh):
    """``distributed_*`` on a port mesh against the JAX package's on a
    one-device mesh: the weighted sums (flat and hierarchical) and the
    PageRank step within ``SUM_RTOL`` / ``SUM_ATOL``, the bfloat16 combine
    within bfloat16's rounding, the frontier min bit for bit."""
    _, g = _graph("rmat", False)
    want = _cached(("distributed",), _distributed_want)
    m = _mesh(mesh)
    n = g.n
    x, xi, fr, inv = (torch.from_numpy(a) for a in _distributed_inputs(g))
    gs = prepare_sharded(m, g)
    assert gs.num_shards == int(np.prod(MESHES[mesh][0]))
    assert shard_blocks_for_mesh(m, g.num_blocks) == (
        -(-g.num_blocks // gs.num_shards) * gs.num_shards)
    for mode in ("flat", "hierarchical"):
        got = to_np(distributed_vertex_reduce(m, n=n, mode=mode)(gs, x))
        np.testing.assert_allclose(got, want["reduce"], rtol=SUM_RTOL, atol=SUM_ATOL)
        got = to_np(distributed_pagerank_step(m, n=n, mode=mode)(gs, x, inv))
        np.testing.assert_allclose(got, want["pagerank"], rtol=SUM_RTOL, atol=SUM_ATOL)
    got = to_np(distributed_vertex_reduce(m, n=n, state_dtype=torch.bfloat16)(gs, x))
    assert got.dtype == want["bf16"].dtype == np.float32
    # each side rounds its shard sums to bfloat16 (8 bits): 2^-8 relative
    np.testing.assert_allclose(got, want["reduce"], rtol=2**-7, atol=0)
    np.testing.assert_allclose(want["bf16"], want["reduce"], rtol=2**-7, atol=0)
    np.testing.assert_array_equal(to_np(distributed_frontier_min(m, n=n)(gs, xi, fr)),
                                  want["min"])


# ----------------------------------------------------------------------
# the plan's surface
# ----------------------------------------------------------------------
def test_plan_surface_on_a_mesh():
    _, g = _graph("rmat", True)
    mesh = _mesh("(2, 2)")
    plan = make_plan(g, mesh=mesh, tuning=None)
    assert plan.is_sharded and plan.num_shards == 4 and plan.axes == ("pod", "data")
    assert plan.tuning_key[-1] == "torch"
    assert plan.tuning_key[-2] == (("pod", 2), ("data", 2))
    sub = make_plan(g, mesh=mesh, shard_axes=("data",), tuning=None)
    assert sub.num_shards == 2 and sub.axes == ("data",)
    assert "mesh(2, 2) reduce=flat" in plan.describe() and "shards=4" in plan.describe()
    assert make_plan(g, tuning=None).describe().startswith("plan[single-device ")
    gs = plan.prepare(g)
    assert plan.prepare(gs) is gs
    with pytest.raises(ValueError, match="prepared for 4 shards"):
        sub.prepare(gs)
    assert make_plan(gs, tuning=None).backend == "compressed"
    assert plan.edge_read_words_per_round(gs) == plan.edge_read_words_per_round(g)
    c = PSAMCost()
    c.charge_edgemap_planned(g, num_shards=4)
    j = JPSAMCost()
    j.charge_edgemap_planned(_graph("rmat", True)[0], num_shards=4)
    assert c.large_reads == j.large_reads == plan.edge_read_words_per_round(g)
    with pytest.raises(TypeError, match="ShardMesh"):
        make_plan(g, mesh=4)
    with pytest.raises(ValueError, match="reduce_mode"):
        make_plan(g, mesh=mesh, reduce_mode="ring")
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), devices=[CPU] * 4)
    with pytest.raises(ValueError):
        make_mesh((2,), ("data",), devices=[CPU] * 3)


def test_calibrate_shard_sweep_on_one_device():
    """Shard counts stay at or below the distinct devices: one CPU, no rows."""
    table = calibrate(n=256, m=1024, quick=True, reps=1, shards=True, device="cpu")
    assert table.to_dict()["shard_sweep"] == []


# ----------------------------------------------------------------------
# repairs: padded exception rows, from_indices, edgemap_sum_compressed
# ----------------------------------------------------------------------
def _ghost_graph():
    """4 blocks: vertex 0 carries the only >= 2^16 gap (one exception, block
    0); vertices 1-3 own one ordinary block each.  On two shards, shard 1 =
    {block 2, block 3} gets a pure-padding exception list (block id 2, the
    shard's block count)."""
    n = 70000
    src = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int64)
    dst = np.array([1, 67000, 2, 3, 4, 5, 6, 7], np.int64)
    jc = jcompress(jbuild_csr(n, src, dst, block_size=32))
    return jc, port_graph(jc)


@pytest.mark.parametrize("route", ["chunks", "fused"])
def test_sharded_streamed_padded_exception_lists(route, monkeypatch):
    """``tests/test_streamed.py``'s ghost-patch case, case for case, through
    the chunk loop and through the fused round's wrapper (its plain version
    on the CPU): frontier {2} must not resurrect vertices 6 and 7."""
    jc, c = _ghost_graph()
    assert c.n_exceptions == 1 and c.num_blocks == 4
    shards = c.shard(2)
    assert to_np(shards[1].exc_block).tolist() == [2]   # pure padding
    monkeypatch.setattr(port_edgemap, "stream_round_route", lambda *a: route)
    x = torch.arange(c.n, dtype=torch.int32)
    for roots in ([2], [0, 2]):
        fr = torch.zeros(c.n, dtype=torch.bool)
        fr[roots] = True
        want = jedgemap_reduce(jc, jnp.asarray(to_np(fr)), jnp.asarray(to_np(x)), monoid="min",
                               mode="sparse")
        if roots == [2]:
            assert not bool(want[1][6]) and not bool(want[1][7])
        for shape in ["(2,)", "(4,)"]:
            plan = make_plan(c, mesh=_mesh(shape), strategy="sparse_streamed", tuning=None)
            gs = plan.prepare(c)
            got = edgemap_reduce(gs, fr, x, monoid="min", plan=plan)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(to_np(a), np.asarray(b))
            got = edgemap_reduce_batched(gs, fr[None], x[None], monoid="min", plan=plan)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(to_np(a)[0], np.asarray(b))


def test_padded_exception_rows_reach_no_scatter():
    """The kernel-side operands of a padded shard: ``exc_row`` is -1 on
    every real block but the exception's, the exact rows of the pad rows
    are all-sentinel, and a filter's words are read for real blocks only."""
    from repro_torch.kernels.compressed_spmv import ops

    _, c = _ghost_graph()
    s0, s1 = c.shard(2)
    words = make_filter(s1).bits
    exact = ops._exception_row_targets(s1, words)
    assert to_np(exact).tolist() == [[c.n] * 32]
    seen = {}
    real = ops.compressed_stream_round

    def spy(*args, **kw):
        seen["exc_row"] = to_np(args[8])
        return real(*args, **kw)

    try:
        ops.compressed_stream_round = spy
        fr = torch.zeros(c.n, dtype=torch.bool)
        fr[[2, 3]] = True
        out, t = ops.compressed_stream_round_graph(
            s1, fr, torch.arange(c.n, dtype=torch.int32), words, map_kind="identity")
        assert seen["exc_row"].tolist() == [-1, -1]
        assert to_np(t).nonzero()[0].tolist() == [4, 5, 6, 7]
        ops.compressed_stream_round_graph(
            s0, fr, torch.arange(c.n, dtype=torch.int32), None, map_kind="identity")
        assert seen["exc_row"].tolist() == [0, -1]
    finally:
        ops.compressed_stream_round = real


def test_from_indices_wraps_negative_ids():
    got = from_indices(8, [-1, -7, 2, 9], "cpu")
    want = jfrom_indices(8, [-1, -7, 2, 9])
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert to_np(got.mask).nonzero()[0].tolist() == [1, 2, 7]
    assert from_indices(8, [-9, 8, 100], "cpu").size == 0


@pytest.mark.parametrize("case", ["small", "past 2^24", "past 2^31"])
def test_edgemap_sum_compressed_promotes_int32(case):
    """An int32 ``x`` sums in float32, as the JAX package's does: same dtype,
    same values, also where an int32 sum would round or wrap (x a multiple
    of a power of two, so every partial sum is exact in float32)."""
    jc, c = _graph("rmat", True)
    rng = np.random.default_rng(1)
    scale = {"small": 1, "past 2^24": 1 << 22, "past 2^31": 1 << 28}[case]
    x = (rng.integers(1, 8, c.n) * scale).astype(np.int32)
    want = np.asarray(jedgemap_sum_compressed(jc, jnp.asarray(x)))
    got = to_np(edgemap_sum_compressed(c, torch.from_numpy(x)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if case != "small":
        assert want.max() > (1 << 24 if case == "past 2^24" else 2**31)


# ----------------------------------------------------------------------
# the core's remaining surface
# ----------------------------------------------------------------------
def test_vertex_subset_surface_matches_jax():
    rng = np.random.default_rng(2)
    m = rng.random(50) < 0.3
    got, want = from_mask(torch.from_numpy(m)), jfrom_mask(jnp.asarray(m))
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert got.n == want.n and got.size == int(want.size)
    assert bool(got.is_empty()) == bool(want.is_empty()) is False
    idx, k = got.to_indices()
    jidx, jk = want.to_indices()
    assert k == int(jk)
    np.testing.assert_array_equal(to_np(idx), np.asarray(jidx))
    from repro.core import empty as jempty
    from repro.core import full as jfull
    assert bool(empty(5, "cpu").is_empty()) and bool(jempty(5).is_empty())
    np.testing.assert_array_equal(to_np(full(5, "cpu").mask), np.asarray(jfull(5).mask))


def test_buckets_update_and_retire_match_jax():
    rng = np.random.default_rng(3)
    b0 = rng.integers(0, 20, 40).astype(np.int32)
    ids = rng.random(40) < 0.4
    new = rng.integers(0, 20, 40).astype(np.int32)
    got = Buckets(torch.from_numpy(b0), 40).update(torch.from_numpy(ids), torch.from_numpy(new))
    want = JBuckets(jnp.asarray(b0), 40).update(jnp.asarray(ids), jnp.asarray(new))
    np.testing.assert_array_equal(to_np(got.bucket_of), np.asarray(want.bucket_of))
    got, want = got.retire(torch.from_numpy(~ids)), want.retire(jnp.asarray(~ids))
    np.testing.assert_array_equal(to_np(got.bucket_of), np.asarray(want.bucket_of))
    assert [int(v) for v in got.next_bucket()[::2]] == [int(v) for v in want.next_bucket()[::2]]


@pytest.mark.parametrize("compressed", [False, True])
def test_graph_surface_matches_jax(compressed):
    jg, g = _graph("exceptions" if compressed else "rmat", compressed)
    assert g.avg_degree == jg.avg_degree
    v = torch.tensor([0, 3, 5])
    np.testing.assert_array_equal(to_np(g.out_degree(v)), np.asarray(jg.out_degree(jnp.asarray([0, 3, 5]))))
    if compressed:
        assert isinstance(g, CompressedCSR)
        assert g.uncompressed_bytes == jg.uncompressed_bytes
        assert g.compression_ratio == jg.compression_ratio
    else:
        assert isinstance(g, CSRGraph)
    assert DEFAULT_EST_ROUNDS == 8
