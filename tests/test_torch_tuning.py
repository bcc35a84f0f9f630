"""Port parity for the tuning package and the plans it feeds.

The table arithmetic (crossovers, the log-density interpolation, the
strategy lookups) must EQUAL the JAX package's on the same sweep rows; a
table written by the JAX package's ``calibrate`` loads in the port and
decides the same knobs; schema errors read the same; ``make_plan`` resolves
explicit argument → table → constants; the batched flavor switch runs the
same branch as the JAX package on either side of its crossover.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax.numpy as jnp
import numpy as np

import repro.tuning.table as jtable
from repro.core import compress as jcompress
from repro.core import edgemap_reduce_batched as jreduce_batched
from repro.data import rmat_graph as jrmat_graph
from repro.tuning import calibrate as jcalibrate
from repro_torch.core import edgemap_reduce_batched, make_plan
from repro_torch.core import edgemap as edgemap_mod
from repro_torch.serving import QueryEngine
from repro_torch.tuning import (
    DEFAULT_DENSE_FRAC,
    DEFAULT_MAX_BATCH,
    SCHEMA_VERSION,
    TuningTable,
    calibrate,
    constants_decision,
    crossover_from_sweep,
    default_table,
    dense_frac_from_crossover,
    flavor_crossover_from_sweep,
)
from repro_torch.tuning import table as ptable
from torch_parity import CPU, port_graph, to_np

SWEEPS = {
    "flip_mid": [
        {"density": 0.01, "dense_us": 100.0, "sparse_us": 10.0},
        {"density": 0.1, "dense_us": 100.0, "sparse_us": 60.0},
        {"density": 1.0, "dense_us": 100.0, "sparse_us": 500.0},
    ],
    "all_dense": [{"density": d, "dense_us": 1.0, "sparse_us": 9.0} for d in (0.01, 1.0)],
    "all_sparse": [{"density": d, "dense_us": 9.0, "sparse_us": 1.0} for d in (0.01, 1.0)],
    "streamed": [
        {"density": 0.001, "dense_us": 50.0, "sparse_us": 40.0, "sparse_streamed_us": 10.0},
        {"density": 0.05, "dense_us": 45.0, "sparse_us": 30.0, "sparse_streamed_us": 35.0},
        {"density": 0.5, "dense_us": 20.0, "sparse_us": 80.0, "sparse_streamed_us": 90.0},
    ],
    "streamed_always": [
        {"density": 0.01, "dense_us": 5.0, "sparse_us": 2.0, "sparse_streamed_us": 1.0},
        {"density": 0.2, "dense_us": 5.0, "sparse_us": 3.0, "sparse_streamed_us": 2.0},
    ],
    "plain_always": [{"density": 0.01, "dense_us": 5.0, "sparse_us": 1.0,
                      "sparse_streamed_us": 2.0}],
    "unsorted": [
        {"density": 0.3, "dense_us": 10.0, "sparse_us": 30.0},
        {"density": 0.003, "dense_us": 10.0, "sparse_us": 1.0},
    ],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_arithmetic_equals_jax(name):
    rows = SWEEPS[name]
    assert crossover_from_sweep(rows) == jtable.crossover_from_sweep(rows)
    assert flavor_crossover_from_sweep(rows) == jtable.flavor_crossover_from_sweep(rows)
    d = crossover_from_sweep(rows)
    assert dense_frac_from_crossover(d) == jtable.dense_frac_from_crossover(d)
    for key in ("dense_us", "sparse_us", "sparse_streamed_us"):
        for dens in (1e-9, 0.002, 0.0316, 0.2, 0.7, 5.0):
            try:
                want = jtable._interp_log_density(rows, key, dens)
            except KeyError:
                with pytest.raises(KeyError):
                    ptable._interp_log_density(rows, key, dens)
                continue
            assert ptable._interp_log_density(rows, key, dens) == want


def _table_data(sweep, **over):
    entry = {
        "density_sweep": sweep,
        "crossover_density": jtable.crossover_from_sweep(sweep),
        "dense_frac": jtable.dense_frac_from_crossover(jtable.crossover_from_sweep(sweep)),
        "chunk_blocks": 64,
        "auto_sparse": "sparse",
        "max_batch": 4,
        **over,
    }
    return {
        "schema_version": SCHEMA_VERSION,
        "host": {"platform": "cpu", "device_kind": "testhost"},
        "hardware": {"name": "cpu"},
        "backends": {"csr": entry, "compressed": dict(entry, lowering="native")},
    }


@pytest.mark.parametrize("name", ["flip_mid", "streamed", "streamed_always", "unsorted"])
def test_strategy_lookups_equal_jax(name):
    data = _table_data(SWEEPS[name])
    t, jt = TuningTable.from_dict(data), jtable.TuningTable.from_dict(data)
    for backend in ("csr", "compressed"):
        for dens in (1e-7, 0.001, 0.01, 0.04, 0.3, 1.0, 3.0):
            assert t.best_strategy(backend, dens) == jt.best_strategy(backend, dens)
            for s in ("dense", "sparse", "sparse_streamed"):
                try:
                    want = jt.strategy_us(backend, s, dens)
                except KeyError:
                    with pytest.raises(KeyError):
                        t.strategy_us(backend, s, dens)
                    continue
                assert t.strategy_us(backend, s, dens) == want
    with pytest.raises(KeyError):
        t.strategy_us("delta", "sparse", 0.1)


def _errors(fn, data):
    try:
        fn(data)
    except ValueError as e:
        return str(e)
    return None


def test_schema_errors_equal_jax(tmp_path):
    good = _table_data(SWEEPS["flip_mid"])
    stale = dict(good, schema_version=SCHEMA_VERSION + 1)
    no_frac = json.loads(json.dumps(good))
    del no_frac["backends"]["csr"]["dense_frac"]
    empty = json.loads(json.dumps(good))
    empty["backends"]["csr"]["density_sweep"] = []
    for bad in (stale, no_frac, empty, {"schema_version": SCHEMA_VERSION}, [1]):
        msg = _errors(TuningTable.from_dict, bad)
        assert msg is not None and msg == _errors(jtable.TuningTable.from_dict, bad)
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(stale))
    with pytest.raises(ValueError, match="schema_version"):
        TuningTable.load(str(path))
    t = TuningTable.from_dict(good)
    assert TuningTable.loads(t.dumps()).to_dict() == t.to_dict()
    t.save(str(tmp_path / "t.json"))
    assert TuningTable.load(str(tmp_path / "t.json")).to_dict() == t.to_dict()


@pytest.fixture(scope="module")
def jax_table_path(tmp_path_factory):
    """A table written by the JAX package's quick calibration on this host."""
    path = tmp_path_factory.mktemp("jax_table") / "table.json"
    jcalibrate(n=256, m=1024, quick=True, block_size=32).save(str(path))
    return str(path)


def _fields(d, drop):
    return {k: v for k, v in dataclasses.asdict(d).items() if k not in drop}


def test_jax_calibrated_table_loads_and_decides_alike(jax_table_path):
    t = TuningTable.load(jax_table_path)
    jt = jtable.TuningTable.load(jax_table_path)
    assert t.to_dict() == jt.to_dict() and t.host_key == jt.host_key
    assert t.backends() == jt.backends() == ["compressed", "csr"]
    for backend in ("csr", "compressed", "auto"):
        for strategy in ("auto", "sparse"):
            got = _fields(t.decide(backend, strategy), {"route"})
            want = _fields(jt.decide(backend, strategy), {"lowering"})
            assert got == want
    assert constants_decision("delta") == t.decide("delta")


def test_make_plan_resolution_order():
    g = port_graph(jrmat_graph(64, 256, seed=5, block_size=32))
    t = TuningTable.from_dict(_table_data(SWEEPS["streamed"], batched_flavor_crossover=0.02,
                                          auto_sparse_batched="sparse_streamed"))
    plan = make_plan(g, tuning=t)
    d = plan.decisions
    assert d.source == "measured" and d.table_host == "cpu/testhost" and d.route == "torch"
    assert (plan.dense_frac, plan.chunk_blocks) == (t.dense_frac("csr"), 64)
    assert plan.batched_flavor_crossover == 0.02 and d.max_batch == 4
    # explicit arguments beat the table, and pin both Beamer predicates
    over = make_plan(g, tuning=t, dense_frac=7.0, chunk_blocks=32)
    assert (over.dense_frac, over.dense_frac_batched, over.chunk_blocks) == (7.0, 7.0, 32)
    assert over.decisions.source == "measured"
    for off in (None, "off"):
        p = make_plan(g, tuning=off)
        assert p.decisions.source == "constants" and p.dense_frac == DEFAULT_DENSE_FRAC
    with pytest.raises(ValueError, match="tuning must be"):
        make_plan(g, tuning="fast")
    # the batched flavor crossover is part of the cache key
    other = make_plan(g, tuning=TuningTable.from_dict(
        _table_data(SWEEPS["streamed"], batched_flavor_crossover=0.5,
                    auto_sparse_batched="sparse_streamed")))
    assert other.tuning_key != plan.tuning_key
    assert dataclasses.replace(plan, batched_flavor_crossover=0.5).tuning_key == other.tuning_key


def test_default_tuning_consults_the_shipped_table_for_auto_only():
    g = port_graph(jrmat_graph(64, 256, seed=5, block_size=32))
    shipped = default_table()
    assert shipped.host["platform"] == "gpu" and shipped.hardware["name"] != "cpu"
    auto = make_plan(g)
    assert auto.decisions.source == "measured"
    assert auto.decisions.table_host == shipped.host_key
    assert auto.decisions.max_batch == shipped.max_batch("csr")
    assert auto.route == "torch"  # the route comes from the device, never the table
    fixed = make_plan(g, strategy="sparse")
    assert fixed.decisions.source == "constants"
    assert make_plan(g, strategy="sparse", tuning=shipped).decisions.source == "measured"


@pytest.mark.parametrize("side", ["below", "above"])
def test_batched_flavor_switch_equals_jax(side):
    """auto's sparse branch, streamed flavor: the measured crossover picks
    the shared live-block loop below the batch's mean density and the
    per-lane chunk loops above it, on both packages."""
    jg = jcompress(jrmat_graph(256, 2048, weighted=True, seed=3, block_size=32))
    g = port_graph(jg)
    B = 3
    rng = np.random.default_rng(8)
    frontiers = rng.random((B, jg.n)) < 0.03
    frontiers[:, 0] = True
    deg = to_np(g.degrees)
    mean = float(np.sum(np.where(frontiers, deg, 0))) / (B * g.m)
    crossover = mean * (2.0 if side == "below" else 0.5)
    xs = np.tile(np.arange(jg.n, dtype=np.int32), (B, 1))
    kw = dict(monoid="min", mode="auto", dense_frac=1.0, auto_sparse="sparse_streamed",
              flavor_crossover=crossover)
    want, wt = jreduce_batched(jg, jnp.asarray(frontiers), jnp.asarray(xs), **kw)
    calls = {"streamed": 0}
    real = edgemap_mod.edgemap_chunked_batched_streamed

    def spy(*a, **k):
        calls["streamed"] += 1
        return real(*a, **k)

    edgemap_mod.edgemap_chunked_batched_streamed = spy
    try:
        got, gt = edgemap_reduce_batched(g, torch.from_numpy(frontiers), torch.from_numpy(xs),
                                         **kw)
    finally:
        edgemap_mod.edgemap_chunked_batched_streamed = real
    assert calls["streamed"] == (1 if side == "below" else 0)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(gt), np.asarray(wt))


def test_calibrate_on_the_cpu_route():
    t = calibrate(n=256, m=1024, quick=True, block_size=32, device=CPU)
    TuningTable.from_dict(json.loads(t.dumps()))
    assert t.host["platform"] == "cpu" and t.host_key == "cpu/cpu"
    assert t.hardware == {"name": "cpu"}
    assert t.backends() == ["compressed", "csr"]
    for backend in t.backends():
        e = t.to_dict()["backends"][backend]
        assert len(e["density_sweep"]) == 3 and "tile_sweep" not in e
        assert "lowering" not in e and e["max_batch"] in (1, 4, 8)
    # the shard sweep times meshes of distinct devices only: none on one CPU,
    # as the JAX package's sweep returns [] on one device
    t = calibrate(n=64, m=128, quick=True, block_size=32, device=CPU, shards=True)
    assert t.to_dict()["shard_sweep"] == []


def test_engine_max_batch_sized_from_table():
    g = port_graph(jrmat_graph(128, 512, seed=7, block_size=32))
    t = TuningTable.from_dict(_table_data(SWEEPS["flip_mid"]))  # max_batch = 4
    plan = make_plan(g, tuning=t)
    assert plan.decisions.max_batch == 4
    assert QueryEngine(g, plan=plan).max_batch == 4
    assert QueryEngine(g, plan=plan, max_batch=2).max_batch == 2  # the argument wins
    assert QueryEngine(g).max_batch == DEFAULT_MAX_BATCH
    assert QueryEngine(g, plan=make_plan(g, tuning=None)).max_batch == DEFAULT_MAX_BATCH
    assert make_plan(g).decisions.max_batch == default_table().max_batch("csr")
