"""Port parity for mutable graphs: ``repro_torch.delta``, ``checkpoint``,
the overlay's PSAM charge, the compaction trigger and the service's edit
path, held to the JAX package on the CPU.

The same seeded edit scripts (``tests/differential.py``) go through the JAX
package's ``DeltaOverlay`` and the port's over the same base graph (built in
JAX, carried over as numpy arrays): every return value and count, the live
edge set and every snapshot field must be equal; queries over the snapshot
must equal JAX's over its own and a from-scratch rebuild's bit for bit;
compactions and checkpoints must be equal and load in either package; the
mutable service's tickets, ``stats`` and ledgers must equal JAX's service.
The crash cases run in subprocesses that import only the port.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import differential as dh
from repro.algorithms import bfs as jbfs
from repro.core import PSAMCost as JPSAMCost
from repro.core import compress as jcompress
from repro.data import rmat_graph as jrmat_graph
from repro.delta import DeltaOverlay as JDeltaOverlay
from repro.delta import compact as jcompact
from repro.delta import load_compacted as jload_compacted
from repro.obs import noop_registry as jnoop_registry
from repro.serving import QueryEngine as JQueryEngine
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving import ServingService as JServingService
from repro.tuning import OverlayTrigger as JOverlayTrigger
from repro_torch.algorithms import bfs, wbfs
from repro_torch.checkpoint import ckpt
from repro_torch.core import (
    PSAMCost,
    build_csr,
    compact_live_blocks,
    compress,
    delta_from_reference_arrays,
    edgemap_reduce,
    make_filter,
    make_mesh,
    make_plan,
    to_reference_arrays,
)
from repro_torch.core.csr import sharded_block_counts
from repro_torch.core.psam import _block_read_words, edgemap_round_read_words
from repro_torch.delta import (
    DeltaGraph,
    DeltaOverlay,
    compact,
    compact_write_words,
    load_compacted,
)
from repro_torch.obs import Registry, noop_registry
from repro_torch.serving import QueryEngine, ServiceConfig, ServingService
from repro_torch.tuning import (
    OverlayTrigger,
    constants_overlay_trigger,
    measured_overlay_trigger,
)
from torch_parity import CPU, port_graph, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT_FIELDS = ("patch_src", "patch_dst", "patch_w", "live_words", "degrees")
SNAPSHOT_META = ("n", "m", "num_blocks", "num_base_blocks", "block_size", "weighted")
COMPRESSED_FIELDS = ("block_first", "deltas", "valid_count", "exc_block", "exc_slot",
                     "exc_value", "block_src", "degrees", "block_weights")
COMPRESSED_META = ("n", "m", "num_blocks", "block_size", "n_exceptions", "weighted")
_CACHE = {}


def _scripted(seed, *, weighted, compressed, n=96, m=400, bs=32, edits=120):
    """The JAX and the port's overlays after one seeded script over the same
    base, the returns of ``apply``, the surviving edge dict and the script."""
    key = (seed, weighted, compressed, n, m, bs, edits)
    if key not in _CACHE:
        g = jrmat_graph(n, m, seed=seed, block_size=bs, weighted=weighted)
        jbase = jcompress(g) if compressed else g
        edges = dh.base_edge_dict(jbase)
        rng = np.random.default_rng(seed + 1000)
        script = dh.random_script(rng, n, edges, edits, weighted=weighted)
        ref = dh.reference_edges(edges, script, weighted=weighted)
        jov, ov = JDeltaOverlay(jbase), DeltaOverlay(port_graph(jbase))
        _CACHE[key] = (jov, ov, jov.apply(script), ov.apply(script), ref, script)
    return _CACHE[key]


def _rebuild(n, edges, *, bs, weighted, compressed):
    """The port's from-scratch graph over the surviving edge set."""
    items = sorted(edges.items())
    src = np.array([u for (u, _), _ in items], np.int32)
    dst = np.array([v for (_, v), _ in items], np.int32)
    w = np.array([x for _, x in items], np.float32)
    g = build_csr(n, src, dst, w if weighted else None, block_size=bs, device=CPU)
    return compress(g) if compressed else g


def _query_results(g, srcs, *, weighted, mode="auto", plan=None):
    """``differential.query_results`` on the port: BFS parents and levels,
    wBFS distances and an exact full-frontier sum, as numpy arrays."""
    out = []
    for s in srcs:
        p, lv = bfs(g, int(s), mode=mode, plan=plan)
        out += [to_np(p), to_np(lv)]
        if weighted:
            out.append(to_np(wbfs(g, int(s), mode=mode, plan=plan)))
    fr = torch.ones(g.n, dtype=torch.bool)
    x = torch.from_numpy((np.arange(g.n) % 7 + 1).astype(np.float32))
    s, touched = edgemap_reduce(g, fr, x, monoid="sum", mode=mode, plan=plan)
    return out + [to_np(s), to_np(touched)]


def _same_snapshot(dg, jdg):
    assert isinstance(dg, DeltaGraph)
    for f in SNAPSHOT_FIELDS:
        a, b = to_np(getattr(dg, f)), np.asarray(getattr(jdg, f))
        if f == "live_words":
            a = a.view(np.uint32)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for k in SNAPSHOT_META:
        assert getattr(dg, k) == getattr(jdg, k), k
    for f in ("block_src", "block_dst", "block_w", "edge_valid", "edge_src", "edge_dst",
              "edge_w"):
        assert np.array_equal(to_np(getattr(dg, f)), np.asarray(getattr(jdg, f))), f
    assert dg.overlay_small_words == jdg.overlay_small_words
    assert dg.compact_write_words == jdg.compact_write_words


def _reference(c):
    """(arrays, meta) of a compressed graph of either package, with the JAX
    package's dtypes."""
    if isinstance(c.block_src, torch.Tensor):
        return to_reference_arrays(c)[1:]
    arrays = {f: None if getattr(c, f) is None else np.asarray(getattr(c, f))
              for f in COMPRESSED_FIELDS}
    return arrays, {k: getattr(c, k) for k in COMPRESSED_META}


def _same_compressed(c, other):
    """Two compressed graphs (either package) equal field for field."""
    (a, ma), (b, mb) = _reference(c), _reference(other)
    for f in COMPRESSED_FIELDS:
        assert (a[f] is None) == (b[f] is None), f
        if a[f] is not None:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f
    for k in COMPRESSED_META:
        assert ma[k] == mb[k], k


# ----------------------------------------------------------------------
# the overlay: edits, counts, live edges and snapshots against JAX's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compressed", [False, True], ids=["csr", "compressed"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_overlay_matches_jax_field_for_field(weighted, compressed):
    for seed in (3, 7):
        jov, ov, jchanged, changed, _, script = _scripted(seed, weighted=weighted,
                                                          compressed=compressed)
        assert changed == jchanged
        for attr in ("num_patch_edges", "num_tombstones", "num_live_edges", "edits_applied"):
            assert getattr(ov, attr) == getattr(jov, attr), attr
        for a, b in zip(ov.live_edges(), jov.live_edges()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        _same_snapshot(ov.snapshot(), jov.snapshot())
        # the same script edit by edit: every return value equal
        one, jone = DeltaOverlay(ov.base), JDeltaOverlay(jov.base)
        for e in script:
            fn, jfn = (one.insert, jone.insert) if e[0] == "insert" else (one.delete,
                                                                         jone.delete)
            assert fn(*e[1:]) == jfn(*e[1:]), e
        _same_snapshot(one.snapshot(), jone.snapshot())


def test_overlay_edit_semantics():
    jg = jrmat_graph(32, 96, seed=0, block_size=16, weighted=True)
    g = port_graph(jg)
    u0, v0 = int(to_np(g.edge_src)[0]), int(to_np(g.edge_dst)[0])
    w0 = float(to_np(g.edge_w)[0])
    ov, jov = DeltaOverlay(g), JDeltaOverlay(jg)

    def both(name, *args):
        got, want = getattr(ov, name)(*args), getattr(jov, name)(*args)
        assert got == want, (name, args)
        for attr in ("num_patch_edges", "num_tombstones", "num_live_edges"):
            assert getattr(ov, attr) == getattr(jov, attr), (name, args, attr)

    assert ov.num_patch_edges == 0 and ov.num_tombstones == 0
    both("insert", 5, 5)            # self-loop: dropped, like build_csr
    assert ov.num_patch_edges == 0
    both("delete", u0, v0)
    assert ov.num_tombstones == 1
    both("insert", u0, v0, w0)      # the same weight revives the base slot
    assert ov.num_tombstones == 0 and ov.num_patch_edges == 0
    both("delete", u0, v0)
    both("insert", u0, v0, w0 + 3.0)  # another weight: slot dead, the patch wins
    assert ov.num_tombstones == 1 and ov.num_patch_edges == 1
    before = ov.num_patch_edges
    both("insert", 1, 2)
    both("insert", 1, 2)            # a duplicate insert upserts
    assert ov.num_patch_edges == before + 1
    both("delete", 1, 2)
    assert ov.num_patch_edges == before
    # a float32 slot weight against a Python float: 0.1 != float32(0.1),
    # so the edge moves to the patch side, as in the JAX package
    wmap = {(int(u), int(v)): float(w) for u, v, w in zip(*jov.live_edges())}
    (u1, v1), w1 = next((k, w) for k, w in wmap.items() if k != (u0, v0))
    both("insert", u1, v1, float(np.float32(w1)))
    both("insert", u1, v1, 0.1)
    both("insert", u1, v1, float(np.float32(0.1)))
    _same_snapshot(ov.snapshot(), jov.snapshot())
    for bad in ((-1, 2), (2, 32)):
        with pytest.raises(ValueError):
            ov.insert(*bad)
    with pytest.raises(ValueError):
        ov.apply([("insert", 3, 4), ("frobnicate", 1, 2)])
    assert ov.edits_applied == jov.edits_applied + 1  # the edit before the bad one applied
    with pytest.raises(TypeError):
        DeltaOverlay(ov.snapshot())
    with pytest.raises(ValueError, match="order"):   # slots out of (src, dst) order
        DeltaOverlay(dataclasses.replace(g, edge_dst=g.edge_dst.flip(0)))


def test_overlay_holds_no_per_slot_dict_and_views_decode_once(monkeypatch):
    import repro_torch.core.compressed as pcompressed

    jov, ov, _, _, _, script = _scripted(3, weighted=True, compressed=True)
    big = [k for k, v in vars(ov).items() if isinstance(v, dict) and len(v) > ov.num_patch_edges]
    assert not big, big
    assert isinstance(ov._keys, np.ndarray) and ov._keys.dtype == np.int64
    decodes = []
    real = pcompressed.decode_block_range
    monkeypatch.setattr(pcompressed, "decode_block_range",
                        lambda *a: decodes.append(a[1:]) or real(*a))
    ov2 = DeltaOverlay(ov.base)   # the base decodes once an overlay ...
    half = len(script) // 2
    for part in (script[:half], script[half:]):
        ov2.apply(part)
        dg = ov2.snapshot()       # ... not once a snapshot, nor an access
        for _ in range(3):
            dg.block_dst, dg.block_w, dg.edge_valid, dg.edge_src, dg.edge_dst
            bfs(dg, 0)
    assert len(decodes) == 1, decodes
    snap = ov.snapshot()
    for name in ("block_dst", "block_w", "edge_valid", "edge_src"):
        torch.testing.assert_close(getattr(dg, name), getattr(snap, name), rtol=0, atol=0)


# ----------------------------------------------------------------------
# queries over the snapshot: JAX over its own, and a rebuild, bit for bit
# ----------------------------------------------------------------------
def _jax_results(seed, *, weighted, compressed, srcs, mode="auto"):
    """``differential.query_results`` of JAX's own snapshot (cached: JAX
    compiles once per graph and mode)."""
    key = ("jax", seed, weighted, compressed, tuple(srcs), mode)
    if key not in _CACHE:
        jov = _scripted(seed, weighted=weighted, compressed=compressed)[0]
        _CACHE[key] = dh.query_results(jov.snapshot(), srcs, weighted=weighted, mode=mode)
    return _CACHE[key]


@pytest.mark.parametrize("compressed", [False, True], ids=["csr", "compressed"])
@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_streamed"])
def test_delta_queries_bit_identical(compressed, mode):
    """BFS, wBFS and an exact sum over the port's snapshot equal a rebuild's
    (both scripts) and JAX's over its own snapshot (the weighted one)."""
    for seed, weighted in [(3, False), (7, True)]:
        _, ov, _, _, ref, _ = _scripted(seed, weighted=weighted, compressed=compressed)
        got = _query_results(ov.snapshot(), [0, 5, 11], weighted=weighted, mode=mode)
        rb = _rebuild(96, ref, bs=32, weighted=weighted, compressed=compressed)
        dh.assert_bit_identical(got, _query_results(rb, [0, 5, 11], weighted=weighted,
                                                    mode=mode), ("rebuild", mode, seed))
    want = _jax_results(7, weighted=True, compressed=compressed, srcs=[0, 5, 11], mode=mode)
    dh.assert_bit_identical(got, want, ("jax", mode))


@pytest.mark.parametrize("max_batch", [1, 8])
def test_delta_engine_batched_matches_jax(max_batch):
    jov, ov, _, _, ref, _ = _scripted(11, weighted=True, compressed=True)
    reqs = [("bfs", {"src": s}) for s in [0, 3, 9, 14, 21]] + [
        ("wbfs", {"src": s}) for s in [1, 6]
    ]
    eng = QueryEngine(ov.snapshot(), max_batch=max_batch, registry=noop_registry())
    got = eng.serve(reqs)
    jeng = JQueryEngine(jov.snapshot(), max_batch=max_batch, registry=jnoop_registry())
    want = jeng.serve(reqs)
    rb = _rebuild(96, ref, bs=32, weighted=True, compressed=True)
    again = QueryEngine(rb, max_batch=max_batch, registry=noop_registry()).serve(reqs)
    for a, b, c in zip(got, want, again):
        fa, fb, fc = [x if isinstance(x, tuple) else (x,) for x in (a, b, c)]
        for x, y, z in zip(fa, fb, fc):
            assert np.array_equal(to_np(x), np.asarray(y))
            assert np.array_equal(to_np(x), to_np(z))
    assert eng.stats == jeng.stats
    assert (eng.cost.large_reads, eng.cost.small_ops) == (jeng.cost.large_reads,
                                                          jeng.cost.small_ops)


# ----------------------------------------------------------------------
# sharding: DeltaGraph.shard field for field, meshes of the CPU
# ----------------------------------------------------------------------
def test_delta_shard_matches_jax_field_for_field():
    jov, ov, *_ = _scripted(2, weighted=False, compressed=True)
    dg, jdg = ov.snapshot(), jov.snapshot()
    for k in [1, 2, 4]:
        shards, jshards = dg.shard(k), jdg.shard(k)
        assert len(shards) == k
        per_b, _ = sharded_block_counts(dg.num_base_blocks, k)
        per_p, _ = sharded_block_counts(dg.num_patch_blocks, k)
        for s, js in zip(shards, jshards):
            assert s.num_base_blocks == per_b and s.num_blocks == per_b + per_p
            _same_snapshot(s, js)
            _same_compressed(s.base, js.base)


@pytest.mark.parametrize("shape", [(1,), (2,), (4,)])
def test_delta_mesh_parity(shape):
    cpu = torch.device("cpu")
    for compressed in (False, True):
        jov, ov, _, _, ref, _ = _scripted(5, weighted=True, compressed=compressed)
        dg = ov.snapshot()
        mesh = make_mesh(shape, ("data",), devices=[cpu] * shape[0])
        plan = make_plan(dg, mesh=mesh, tuning=None)
        assert plan.backend == "delta", plan.backend
        got = _query_results(dg, [0, 7], weighted=True, plan=plan)
        want = _jax_results(5, weighted=True, compressed=compressed, srcs=[0, 7])
        dh.assert_bit_identical(got, want, (compressed, shape))
        rb = _rebuild(96, ref, bs=32, weighted=True, compressed=compressed)
        dh.assert_bit_identical(got, _query_results(rb, [0, 7], weighted=True))
        assert plan.edge_read_words_per_round(plan.prepare(dg)) == \
            plan.edge_read_words_per_round(dg)


def test_delta_plan_and_carry():
    jov, ov, *_ = _scripted(3, weighted=True, compressed=True)
    dg, jdg = ov.snapshot(), jov.snapshot()
    assert make_plan(dg, tuning=None).backend == "delta"
    with pytest.raises(TypeError):
        compact_live_blocks(dg, make_filter(dg))
    # a JAX snapshot carried into the port serves as the port's own does
    kind = "compressed" if hasattr(jdg.base, "deltas") else "csr"
    base_arrays = {f: getattr(jdg.base, f) for f in COMPRESSED_FIELDS}
    base_meta = {k: getattr(jdg.base, k) for k in COMPRESSED_META}
    carried = delta_from_reference_arrays(
        kind, {k: None if v is None else np.asarray(v) for k, v in base_arrays.items()},
        base_meta, {f: np.asarray(getattr(jdg, f)) for f in SNAPSHOT_FIELDS},
        {k: getattr(jdg, k) for k in SNAPSHOT_META}, CPU)
    _same_snapshot(carried, jdg)
    dh.assert_bit_identical(_query_results(carried, [0, 4], weighted=True),
                            _query_results(dg, [0, 4], weighted=True))


# ----------------------------------------------------------------------
# compaction and checkpoints, both ways
# ----------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_compact_and_checkpoints_cross_both_ways(weighted, tmp_path):
    jov, ov, _, _, ref, _ = _scripted(13, weighted=weighted, compressed=True)
    cost, jcost = PSAMCost(registry=noop_registry()), JPSAMCost(registry=jnoop_registry())
    c = compact(ov, cost=cost, ckpt_dir=str(tmp_path / "port"), step=0)
    jc = jcompact(jov, cost=jcost, ckpt_dir=str(tmp_path / "jax"), step=0)
    _same_compressed(c, jc)
    assert cost.large_writes == jcost.large_writes == compact_write_words(c)
    rb = _rebuild(96, ref, bs=32, weighted=weighted, compressed=True)
    _same_compressed(c, rb)
    # the two saves hold the same leaves, byte for byte
    for name in ("arrays.npz", "manifest.json"):
        assert (tmp_path / "port" / "step_0000000000" / name).exists()
    with np.load(tmp_path / "port" / "step_0000000000" / "arrays.npz") as a, \
            np.load(tmp_path / "jax" / "step_0000000000" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f
    # a JAX save loads in the port, a port save loads in JAX
    loaded, step = load_compacted(str(tmp_path / "jax"), device=CPU)
    assert step == 0
    _same_compressed(loaded, jc)
    jloaded, jstep = jload_compacted(str(tmp_path / "port"))
    assert jstep == 0
    _same_compressed(c, jloaded)
    assert load_compacted(str(tmp_path / "none"), device=CPU) == (None, None)
    dh.assert_bit_identical(_query_results(loaded, [0, 5], weighted=weighted),
                            _query_results(rb, [0, 5], weighted=weighted))
    rebased = DeltaOverlay(c)
    assert rebased.num_patch_edges == 0 and rebased.num_tombstones == 0


def test_checkpoint_tree_order_and_keep(tmp_path):
    tree = {"b": torch.arange(3), "a": [np.ones(2, np.float32), (np.zeros(1, np.uint16),
                                                                 None)]}
    for step in range(5):
        ckpt.save(str(tmp_path), step, tree, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]
    with np.load(tmp_path / "step_0000000004" / "arrays.npz") as a:
        assert a["leaf_0"].dtype == np.float32 and a["leaf_1"].dtype == np.uint16
        assert np.array_equal(a["leaf_2"], np.arange(3))
    import json

    import jax

    manifest = json.loads((tmp_path / "step_0000000004" / "manifest.json").read_text())
    assert manifest["n_leaves"] == 3
    assert manifest["treedef"] == str(jax.tree.flatten(
        {"b": 0, "a": [0, (0, None)]})[1])
    back, step = ckpt.restore_latest(str(tmp_path), tree, device=CPU)
    assert step == 4 and torch.equal(back["b"], tree["b"])
    assert back["a"][1][0].dtype == torch.int16 and back["a"][1][1] is None
    assert ckpt.restore_latest(str(tmp_path / "empty"), tree, device=CPU) == (None, None)


_CRASH_SETUP = r"""
import os, sys
import numpy as np
import repro_torch.checkpoint.ckpt as ck
from repro_torch.core import compress
from repro_torch.data import rmat_graph
from repro_torch.delta import DeltaOverlay, compact

assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
D = os.environ["CKPT_DIR"]
base = compress(rmat_graph(64, 256, seed=21, block_size=32, weighted=False, device="cpu"))
ov = DeltaOverlay(base)
ov.apply([("insert", 1, 2), ("insert", 3, 4), ("delete",
          int(base.edge_src[0]), int(base.edge_dst[0]))])
c0 = compact(ov, ckpt_dir=D, step=0)   # the pre-state, published cleanly
ov1 = DeltaOverlay(c0)
ov1.apply([("insert", 5, 6), ("insert", 7, 8)])
"""

_CRASH_MODES = {
    "during_arrays": r"""
def boom(path, arrays):
    with open(path, "wb") as fh:
        fh.write(b"torn partial garbage")
    os._exit(42)
ck._savez = boom
""",
    "before_manifest": r"""
ck.json.dump = lambda *a, **k: os._exit(42)
""",
    "before_publish": r"""
ck.os.replace = lambda *a, **k: os._exit(42)
""",
    "after_publish": r"""
_orig = ck.os.replace
def pub(src, dst):
    _orig(src, dst)
    os._exit(42)
ck.os.replace = pub
""",
}


@pytest.mark.parametrize("mode", sorted(_CRASH_MODES))
def test_crash_recovery_between_checkpoint_writes(mode, tmp_path):
    """Kill a port-only process at each write boundary of the step-1 save:
    recovery loads exactly the pre- (step 0) or post- (step 1) compaction
    graph, never a torn one."""
    code = (_CRASH_SETUP + _CRASH_MODES[mode]
            + "\ncompact(ov1, ckpt_dir=D, step=1)\nraise SystemExit('unreachable')\n")
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": "src", "CKPT_DIR": str(tmp_path)},
        cwd=ROOT, timeout=300,
    )
    assert r.returncode == 42, (r.returncode, r.stderr[-3000:])
    from repro_torch.data import rmat_graph

    base = compress(rmat_graph(64, 256, seed=21, block_size=32, weighted=False, device=CPU))
    ov = DeltaOverlay(base)
    ov.apply([("insert", 1, 2), ("insert", 3, 4),
              ("delete", int(base.edge_src[0]), int(base.edge_dst[0]))])
    c0 = compact(ov)
    ov1 = DeltaOverlay(c0)
    ov1.apply([("insert", 5, 6), ("insert", 7, 8)])
    c1 = compact(ov1)
    loaded, step = load_compacted(str(tmp_path), device=CPU)
    want, want_step = (c1, 1) if mode == "after_publish" else (c0, 0)
    assert step == want_step, (mode, step)
    for f in COMPRESSED_FIELDS[:-1]:
        assert torch.equal(getattr(loaded, f), getattr(want, f)), f
    assert (loaded.n, loaded.m, loaded.num_blocks, loaded.block_size) == (
        want.n, want.m, want.num_blocks, want.block_size)


# ----------------------------------------------------------------------
# PSAM: the overlay charge, compaction the only large write
# ----------------------------------------------------------------------
@pytest.mark.parametrize("batch,shards", [(1, 1), (8, 1), (4, 2)])
def test_psam_overlay_charge_exact(batch, shards):
    jov, ov, *_ = _scripted(17, weighted=False, compressed=True)
    dg = ov.snapshot()
    reg = Registry()
    cost, jcost = PSAMCost(registry=reg), JPSAMCost(registry=jnoop_registry())
    cost.charge_edgemap_overlay(dg, batch=batch, num_shards=shards)
    jcost.charge_edgemap_overlay(jov.snapshot(), batch=batch, num_shards=shards)
    _, base_padded = sharded_block_counts(dg.num_base_blocks, shards)
    exp_reads = _block_read_words(dg.base, base_padded)
    exp_small = dg.overlay_small_words + batch * (3 * dg.n + (shards - 1) * dg.n)
    assert (cost.large_reads, cost.small_ops, cost.large_writes) == (exp_reads, exp_small, 0)
    assert (cost.large_reads, cost.small_ops) == (jcost.large_reads, jcost.small_ops)
    assert reg.counter("sage_psam_large_read_words_total", labels=("charge",)).value(
        charge="edgemap_overlay") == float(exp_reads)
    assert reg.counter("sage_psam_small_ops_words_total", labels=("charge",)).value(
        charge="edgemap_overlay") == float(exp_small)
    assert edgemap_round_read_words(dg, shards) == edgemap_round_read_words(dg.base, shards)


def test_compact_is_the_only_large_write():
    jov, ov, *_ = _scripted(19, weighted=False, compressed=True)
    dg = ov.snapshot()
    reg = Registry()
    cost = PSAMCost(registry=reg)
    for b in (1, 4, 8):
        cost.charge_edgemap_overlay(dg, batch=b)
    assert cost.large_writes == 0
    c = compact(ov, cost=cost, registry=reg)
    w = compact_write_words(c)
    assert cost.large_writes == w
    mirror = reg.counter("sage_psam_large_write_words_total", labels=("charge",))
    assert mirror.value(charge="compact") == float(w) and mirror.value() == float(w)
    assert reg.counter("sage_delta_compactions_total").value() == 1.0
    assert reg.gauge("sage_delta_last_compact_write_words").value() == float(w)


def test_engine_charges_overlay_not_batched_for_delta():
    jov, ov, *_ = _scripted(23, weighted=False, compressed=True)
    reg = Registry()
    eng = QueryEngine(ov.snapshot(), max_batch=4, registry=reg)
    eng.serve([("bfs", {"src": 0}), ("bfs", {"src": 1})])
    jeng = JQueryEngine(jov.snapshot(), max_batch=4, registry=jnoop_registry())
    jeng.serve([("bfs", {"src": 0}), ("bfs", {"src": 1})])
    assert eng.cost.large_writes == 0
    assert (eng.cost.large_reads, eng.cost.small_ops) == (jeng.cost.large_reads,
                                                          jeng.cost.small_ops)
    small = reg.counter("sage_psam_small_ops_words_total", labels=("charge",))
    reads = reg.counter("sage_psam_large_read_words_total", labels=("charge",))
    assert small.value(charge="edgemap_overlay") > 0.0
    assert reads.value(charge="edgemap_batched") == 0.0


# ----------------------------------------------------------------------
# the service's edit path, against JAX's service
# ----------------------------------------------------------------------
def _services(jbase, **cfg):
    jsvc = JServingService(JDeltaOverlay(jbase), config=JServiceConfig(**cfg),
                           registry=jnoop_registry())
    svc = ServingService(DeltaOverlay(port_graph(jbase)), config=ServiceConfig(**cfg),
                         registry=noop_registry())
    return jsvc, svc


def _same_services(svc, jsvc, tickets, jtickets):
    assert len(tickets) == len(jtickets)
    for t, jt in zip(tickets, jtickets):
        for f in ("id", "op", "tenant", "params", "arrival", "deadline", "status",
                  "finished_at", "rounds", "words", "est_words"):
            assert getattr(t, f) == getattr(jt, f), (f, getattr(t, f), getattr(jt, f))
        res = t.result if isinstance(t.result, tuple) else (t.result,)
        jres = jt.result if isinstance(jt.result, tuple) else (jt.result,)
        for a, b in zip(res, jres):
            assert np.array_equal(to_np(a), np.asarray(b))
    assert svc.stats == jsvc.stats
    assert svc.engine.stats == jsvc.engine.stats
    assert {k: dict(vars(v)) for k, v in svc.ledgers.items()} == {
        k: dict(vars(v)) for k, v in jsvc.ledgers.items()}
    assert (svc.cost.large_reads, svc.cost.small_ops, svc.cost.large_writes) == (
        jsvc.cost.large_reads, jsvc.cost.small_ops, jsvc.cost.large_writes)
    assert svc._round_words == jsvc._round_words
    assert svc._edits_per_compact == jsvc._edits_per_compact
    assert svc._compact_step == jsvc._compact_step
    assert svc.observed_rounds == jsvc.observed_rounds
    # the same cohort cache keys; JAX retraces a key at each new snapshot
    # shape, the port binds each key once
    assert set(svc.trace_counts) == set(jsvc.trace_counts)
    assert all(c == 1 for c in svc.trace_counts.values())


def test_service_edit_admission_reject_only():
    jg = jcompress(jrmat_graph(64, 256, seed=6, block_size=32))
    cfg = dict(admission="defer", budgets={"poor": (1e-6, 0.0)})
    for svc in _services(jg, **cfg):
        # edits are never deferred, even under admission="defer"
        assert svc.submit_edit("insert", 1, 2, tenant="poor") is False
        assert svc.stats["edits_rejected"] == 1 and svc.stats["edits_applied"] == 0
        assert svc.submit_edit("insert", 1, 2, tenant="rich") is True
        svc.tick(0.0)
        assert svc.stats["edits_applied"] == 1
        with pytest.raises(ValueError):
            svc.submit_edit("upsert", 1, 2)
    jsvc, svc = _services(jg, **cfg)
    for s in (jsvc, svc):
        s.submit_edit("insert", 1, 2, tenant="poor")
        s.submit_edit("delete", 3, 4, tenant="rich")
    assert svc.stats == jsvc.stats and svc._estimate_edit_words() == jsvc._estimate_edit_words()


def test_service_plain_graph_rejects_edits():
    g = compress(port_graph(jrmat_graph(64, 256, seed=6, block_size=32)))
    svc = ServingService(g, registry=noop_registry())
    with pytest.raises(TypeError):
        svc.submit_edit("insert", 1, 2)
    assert svc.force_compact() is None


def test_service_triggered_compaction_persists_and_matches_jax(tmp_path):
    """A stream of queries and edits from two tenants (one under a budget
    that rejects edits) on both services: triggered compactions persist,
    and tickets, stats, ledgers and the PSAM account equal JAX's."""
    jg = jcompress(jrmat_graph(96, 400, seed=8, block_size=32, weighted=True))
    edges = dh.base_edge_dict(jg)
    script = dh.random_script(np.random.default_rng(55), 96, edges, 96, weighted=True)
    regs = (jnoop_registry(), Registry())

    def stream(svc):
        tickets, admitted = [], []
        for i, e in enumerate(script):
            now = 0.002 * i
            if svc.submit_edit(e[0], e[1], e[2], *e[3:], tenant=("a", "b")[i % 2], now=now):
                admitted.append(e)
            if i % 10 == 0:
                tickets.append(svc.submit(("bfs", "wbfs")[(i // 10) % 2], src=i % 96,
                                          now=now, tenant="q"))
            svc.tick(now)
        tickets.append(svc.submit("bfs", src=0, now=1.0))
        svc.drain(1.0)
        svc.force_compact(1.0)
        return tickets, admitted

    cfg = dict(slo=0.01, max_batch=4, compact_keep=2,
               compact_trigger=OverlayTrigger(hysteresis=0.05), budgets={"b": (30.0, 100.0)})
    jcfg = {**cfg, "compact_trigger": JOverlayTrigger(hysteresis=0.05),
            "ckpt_dir": str(tmp_path / "jax")}
    jsvc = JServingService(JDeltaOverlay(jg), config=JServiceConfig(**jcfg), registry=regs[0])
    svc = ServingService(DeltaOverlay(port_graph(jg)),
                         config=ServiceConfig(**{**cfg, "ckpt_dir": str(tmp_path / "port")}),
                         registry=regs[1])
    (jt, jadmitted), (t, admitted) = stream(jsvc), stream(svc)
    assert admitted == jadmitted
    _same_services(svc, jsvc, t, jt)
    st = svc.stats
    assert st["compactions"] >= 2 and st["edits_rejected"] > 0
    assert st["edits_applied"] == len(admitted)
    assert svc.overlay.num_patch_edges == 0 and svc.overlay.num_tombstones == 0
    # the served base equals a from-scratch rebuild; the newest published
    # checkpoint is that base, in either package; compact_keep steps stay
    ref = dh.reference_edges(edges, admitted, weighted=True)
    rb = _rebuild(96, ref, bs=32, weighted=True, compressed=True)
    _same_compressed(svc.overlay.base, rb)
    loaded, step = load_compacted(str(tmp_path / "port"), device=CPU)
    assert step == svc._compact_step - 1
    _same_compressed(loaded, rb)
    _same_compressed(loaded, jload_compacted(str(tmp_path / "jax"))[0])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 2
    want = jbfs(dh.rebuild(96, ref, block_size=32, weighted=True, compressed=True), 0)
    for a, b in zip(bfs(svc.engine.graph, 0), want):
        assert np.array_equal(to_np(a), np.asarray(b))
    reg = regs[1]
    assert reg.gauge("sage_delta_patch_edges").value() == 0.0
    assert reg.counter("sage_delta_compactions_total").value() == float(st["compactions"])
    assert reg.counter("sage_delta_edits_total", labels=("kind",)).value() == len(admitted)


# ----------------------------------------------------------------------
# the compaction trigger
# ----------------------------------------------------------------------
def test_constants_trigger_breakeven_arithmetic():
    jov, ov, *_ = _scripted(29, weighted=False, compressed=True)
    dg, jdg = ov.snapshot(), jov.snapshot()
    trig = constants_overlay_trigger()
    assert (trig.overlay_cost_scale, trig.hysteresis, trig.source) == (1.0, 1.0, "constants")
    w, ov_words = float(dg.compact_write_words), float(dg.overlay_small_words)
    breakeven = 4.0 * w / ov_words
    assert not trig.should_compact(dg, sweeps_since_compact=breakeven * 0.5, omega=4.0) \
        or breakeven * 0.5 <= 1.0
    assert trig.should_compact(dg, sweeps_since_compact=breakeven * 2.0 + 1.0, omega=4.0)
    jtrig = JOverlayTrigger()
    for sweeps in (0.0, 1.0, breakeven * 0.9, breakeven, breakeven * 1.1, 1e6):
        for hyst in (0.5, 1.0, 3.0):
            a = OverlayTrigger(hysteresis=hyst).should_compact(dg, sweeps_since_compact=sweeps)
            b = JOverlayTrigger(hysteresis=hyst).should_compact(jdg,
                                                                sweeps_since_compact=sweeps)
            assert a == b, (sweeps, hyst)
    assert jtrig.should_compact(jdg, sweeps_since_compact=1e6)


def test_measured_trigger_scale_in_range():
    g = port_graph(jcompress(jrmat_graph(128, 512, seed=4, block_size=32)))
    trig = measured_overlay_trigger(g, edits=64, seed=1, reps=2)
    assert trig.source == "measured" and 0.05 <= trig.overlay_cost_scale <= 20.0
    assert trig.hysteresis == constants_overlay_trigger().hysteresis
