"""Port parity for graph serving on a process plan: ``QueryEngine``,
``ServingService`` and the mutable service with one shard a rank, the
combine on ``torch.distributed`` (gloo, on the CPU).

One spawn of 4 ranks (``tests/process_serving_ranks.py`` is the rank side,
which imports no JAX) serves on a (2, 2) hierarchical mesh over all four,
then on two (2,) flat meshes over ranks 0-1 and 2-3, while this process
runs the JAX package's one-device engine and services on the same graphs
(``rmat_graph(128, 512, weighted=True, seed=7, block_size=32)``, CSR and
compressed; the mutable leg's graph and edit script are
``tests/test_torch_delta.py``'s).  What is held, and to what:

* the engine: each lane of one flush equal to its single-query run on the
  same process plan bit for bit (``tests/test_serving.py``'s
  ``test_batched_sharded_parity``); BFS and wBFS equal to JAX's one-device
  ``QueryEngine`` bit for bit, PPR (``max_rounds=30``) and
  ``pagerank_iteration`` within ``SUM_ATOL`` (the shards' sums combine in
  another order); ``stats``, cache misses and the PSAM account equal to
  the in-process plan's of the same shape (a ``ShardMesh`` of CPU devices);
* the service (two tenants, one deferred by its budget, ``round_quantum=2``
  so lanes repack, depth, deadline and forced flushes): every ticket's
  result equal to JAX's one-device ``ServingService``'s by the engine's
  rule; tickets, ``stats``, ledgers, cache misses, the PSAM account and
  the read quantum equal to the in-process plan's;
* the mutable service over ``DeltaOverlay`` with one ``ckpt_dir`` shared by
  both ranks: tickets and admitted edits equal to JAX's service, each
  compaction persisted once (rank 0's ``save_compacted`` calls, rank 1
  none), ``compact_keep`` steps left, the newest equal to JAX's checkpoint
  and to every rank's own fold;
* three refusals, each a ``ValueError`` on every rank of the pair: ranks
  built with other ``max_batch``, ranks that submit other sources, a
  compaction whose write fails on rank 0 (a file where ``ckpt_dir`` goes);
* every rank equal to rank 0 exactly, its results on its own device.

A rank still running after ``SPAWN_LIMIT_S`` is killed and the tests fail.
"""
import multiprocessing
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import differential as dh
from process_serving_ranks import (
    ENGINE_SOURCES,
    MAX_BATCH,
    MESHES,
    MUTABLE_CFG,
    MUTABLE_HYSTERESIS,
    SERVICE_CFG,
    SERVICE_REQUESTS,
    capped_budget,
    engine_requests,
    mutable_stream,
    rank_main,
    service_stream,
)
from repro.core import compress as jcompress
from repro.data import rmat_graph as jrmat_graph
from repro.delta import DeltaOverlay as JDeltaOverlay
from repro.delta import load_compacted as jload_compacted
from repro.obs import noop_registry as jnoop_registry
from repro.serving import QueryEngine as JQueryEngine
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving import ServingService as JServingService
from repro.tuning import OverlayTrigger as JOverlayTrigger
from repro_torch.core import edgemap_round_read_words
from repro_torch.delta import load_compacted
from torch_parity import port_graph, reference_arrays, write_payload

SPAWN_LIMIT_S = 120   # ranks still running after this are killed: a hung rank fails
SUM_ATOL = 1e-5       # float32 sums combined in another order (tests/test_torch_sharding.py)
OPS = ("bfs", "wbfs", "ppr", "pagerank_iteration")
ENGINE_LEGS = [("(2, 2) hierarchical", "csr"), ("(2, 2) hierarchical", "compressed"),
               ("(2,) flat, ranks 0-1", "csr"), ("(2,) flat, ranks 2-3", "compressed")]
SERVICE_LEGS = ["(2, 2) hierarchical", "(2,) flat, ranks 2-3"]


def _jax_graphs():
    g = jrmat_graph(128, 512, weighted=True, seed=7, block_size=32)
    mutable = jcompress(jrmat_graph(96, 400, seed=8, block_size=32, weighted=True))
    return {"csr": g, "compressed": jcompress(g), "mutable": mutable}


def _payload(tmp, jgraphs):
    rng = np.random.default_rng(1)
    edges = dh.base_edge_dict(jgraphs["mutable"])
    (tmp / "not_a_dir").write_text("a file where the checkpoint directory should be")
    return {
        "graphs": {k: reference_arrays(g) for k, g in jgraphs.items()},
        "prs": [rng.random(128).astype(np.float32) for _ in ENGINE_SOURCES],
        "service_sources": [int(s) for s in rng.integers(0, 128, SERVICE_REQUESTS)],
        "script": dh.random_script(np.random.default_rng(55), 96, edges, 96, weighted=True),
        "ckpt_dir": str(tmp / "ckpt"),
        "not_a_dir": str(tmp / "not_a_dir"),
    }


def _jax_references(tmp, jgraphs, payload):
    """JAX's one-device engine (one flush a graph: one jit an op), service
    and mutable service on the ranks' streams."""
    out = {"engine": {}}
    reqs = engine_requests([jnp.asarray(p) for p in payload["prs"]])
    for kind in ("csr", "compressed"):
        eng = JQueryEngine(jgraphs[kind], max_batch=MAX_BATCH, registry=jnoop_registry())
        out["engine"][kind] = eng.serve(reqs)
    words = edgemap_round_read_words(port_graph(jgraphs["csr"]))
    svc = JServingService(jgraphs["csr"], config=JServiceConfig(
        **SERVICE_CFG, budgets=capped_budget(words)), registry=jnoop_registry())
    out["service"] = service_stream(svc, payload["service_sources"])
    msvc = JServingService(
        JDeltaOverlay(jgraphs["mutable"]),
        config=JServiceConfig(**MUTABLE_CFG, ckpt_dir=str(tmp / "jax"),
                              compact_trigger=JOverlayTrigger(hysteresis=MUTABLE_HYSTERESIS)),
        registry=jnoop_registry())
    out["mutable"] = (*mutable_stream(msvc, payload["script"]), msvc)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(every rank's results, JAX's references, the payload, the tmp dir)."""
    tmp = tmp_path_factory.mktemp("process_serving")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, 4, str(tmp / "init"),
                                                 str(tmp / "payload.pkl"), str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        jgraphs = _jax_graphs()
        payload = _payload(tmp, jgraphs)
        write_payload(tmp / "payload.pkl", payload)
        want = _jax_references(tmp, jgraphs, payload)
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = sorted(tmp.glob("rank*.err"))
    assert not errs, errs[0].read_text()
    assert not hung, f"ranks {hung} still running after {SPAWN_LIMIT_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return ranks, want, payload, tmp


def _ranks_of(mesh):
    return MESHES[mesh][3]


def _same(a, b):
    """Two nested records (dicts, lists, tuples, numpy arrays) equal exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a.keys(), b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b, (a, b)


def _twin_keys(counts, mesh_key):
    """A process plan's cache keys with the mesh element checked against
    ``("process", the in-process key)`` and replaced by the latter."""
    out = {}
    for key, v in counts.items():
        assert key[1] == ("process", mesh_key), key
        out[key[:1] + (mesh_key,) + key[2:]] = v
    return out


def _mesh_key(mesh):
    shape, axes = MESHES[mesh][:2]
    return tuple(zip(axes, shape))


def _like_jax(op, got, want):
    """The engine's rule: BFS and wBFS bit for bit, PPR and PageRank
    iterations within ``SUM_ATOL`` (PPR's round count exactly)."""
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if op in ("bfs", "wbfs"):
            assert a.dtype == b.dtype and np.array_equal(a, b), op
        elif a.dtype.kind in "iu":
            assert np.array_equal(a, b), op
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=SUM_ATOL)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("mesh,kind", ENGINE_LEGS)
def test_engine_on_a_process_plan(spawned, mesh, kind, op):
    ranks, want, _, _ = spawned
    members = _ranks_of(mesh)
    lanes = [i for i, (o, _) in enumerate(engine_requests([None] * len(ENGINE_SOURCES)))
             if o == op]
    first = ranks[members[0]]
    rec = first["engine"][mesh, kind]
    for i in lanes:
        lane, single = rec["results"][i], rec["single"][i]
        if op == "ppr":  # the single run counts its rounds in an int
            assert int(lane[2]) == int(single[2])
            lane, single = lane[:2], single[:2]
        _same(lane, single)
        _like_jax(op, rec["results"][i], want["engine"][kind][i])
    for r in members:
        got = ranks[r]["engine"][mesh, kind]
        _same(got["results"], rec["results"])
        assert got["devices"] == ["cpu"]
        assert got["shards"] == (members.index(r), 1, len(members))
    twin = first["twin"]["engine", mesh, kind]
    assert rec["stats"] == twin["stats"] and rec["cost"] == twin["cost"]
    assert _twin_keys(rec["trace_counts"], _mesh_key(mesh)) == twin["trace_counts"]
    for i in lanes:
        _like_jax(op, twin["results"][i], want["engine"][kind][i])


@pytest.mark.parametrize("mesh", SERVICE_LEGS)
def test_service_on_a_process_plan(spawned, mesh):
    ranks, want, _, _ = spawned
    members = _ranks_of(mesh)
    rec = ranks[members[0]]["service"][mesh]
    twin = ranks[members[0]]["twin"]["service", mesh]
    for r in members:
        got = ranks[r]["service"][mesh]
        _same({k: v for k, v in got.items() if k != "trace_counts"},
              {k: v for k, v in rec.items() if k != "trace_counts"})
        assert got["trace_counts"] == rec["trace_counts"] and got["devices"] == ["cpu"]
    _same({k: v for k, v in rec.items() if k not in ("trace_counts", "devices")},
          {k: v for k, v in twin.items() if k not in ("trace_counts", "devices")})
    assert _twin_keys(rec["trace_counts"], _mesh_key(mesh)) == twin["trace_counts"]
    assert len(rec["tickets"]) == len(want["service"]) == SERVICE_REQUESTS
    for t, jt in zip(rec["tickets"], want["service"]):
        assert (t["id"], t["op"], t["status"]) == (jt.id, jt.op, jt.status) == (
            t["id"], t["op"], "done")
        _like_jax(t["op"], t["result"], jt.result)
    st = rec["stats"]
    assert st["depth_flushes"] and st["deadline_flushes"] and st["forced_flushes"]
    assert st["deferred"] and st["repacks"], st


def test_mutable_service_on_a_process_plan(spawned):
    """Tickets and admitted edits equal to JAX's service; the accounting
    equal to the in-process plan's; the ranks identical; the final base
    equal on every rank to JAX's."""
    ranks, want, _, _ = spawned
    jtickets, jadmitted, jsvc = want["mutable"]
    rec = ranks[0]["mutable"]
    twin = ranks[0]["twin"]["mutable"]
    assert rec["admitted"] == jadmitted
    assert len(rec["tickets"]) == len(jtickets)
    for t, jt in zip(rec["tickets"], jtickets):
        for f in ("id", "op", "tenant", "params", "arrival", "deadline", "status",
                  "finished_at"):
            assert t[f] == getattr(jt, f), (f, t[f], getattr(jt, f))
        _like_jax(t["op"], t["result"], jt.result)
    assert rec["stats"] == jsvc.stats and rec["compact_step"] == jsvc._compact_step
    assert rec["stats"]["compactions"] >= 2 and rec["stats"]["edits_rejected"] > 0
    skip = ("trace_counts", "devices", "saves", "reloaded")
    _same({k: v for k, v in rec.items() if k not in skip},
          {k: v for k, v in twin.items() if k not in skip})
    assert _twin_keys(rec["trace_counts"], _mesh_key("(2,) flat, ranks 0-1")) == \
        twin["trace_counts"]
    got = ranks[1]["mutable"]
    _same({k: v for k, v in got.items() if k != "saves"},
          {k: v for k, v in rec.items() if k != "saves"})
    jbase = reference_arrays(jsvc.overlay.base)
    for name, a in rec["base"]["arrays"].items():
        assert (a is None) == (jbase[1][name] is None), name
        assert a is None or np.array_equal(a, np.asarray(jbase[1][name])), name


def test_compactions_persisted_once(spawned):
    """Rank 0 wrote every step once, rank 1 none; ``compact_keep`` steps
    stay; the newest loads equal to JAX's checkpoint and to each rank's
    own fold."""
    ranks, want, payload, tmp = spawned
    r0, r1 = ranks[0]["mutable"], ranks[1]["mutable"]
    steps = r0["compact_step"]
    assert r0["saves"] == list(range(steps)) and r1["saves"] == []
    assert sorted(os.listdir(payload["ckpt_dir"])) == sorted(os.listdir(tmp / "jax")) == [
        f"step_{s:010d}" for s in range(steps - MUTABLE_CFG["compact_keep"], steps)]
    loaded, step = load_compacted(payload["ckpt_dir"], device="cpu")
    jloaded, jstep = jload_compacted(str(tmp / "jax"))
    assert step == jstep == steps - 1
    mine, theirs = reference_arrays(loaded), reference_arrays(jloaded)
    assert mine[2] == theirs[2]
    for name, a in mine[1].items():
        assert (a is None) == (theirs[1][name] is None), name
        assert a is None or np.array_equal(a, np.asarray(theirs[1][name])), name
    for rr in (r0, r1):
        assert rr["reloaded"][0] == step
        _same(rr["reloaded"][1], rr["base"])


def test_ranks_price_a_round_alike(spawned):
    """Every rank's read quantum, over the plain graph and over each
    ``DeltaGraph`` snapshot (whose patch ranges differ by rank), equals the
    in-process plan's."""
    ranks = spawned[0]
    for mesh in SERVICE_LEGS:
        members = _ranks_of(mesh)
        twin = ranks[members[0]]["twin"]["service", mesh]["round_words"]
        assert [ranks[r]["service"][mesh]["round_words"] for r in members] == \
            [twin] * len(members)
    twin = ranks[0]["twin"]["mutable"]["round_words_seen"]
    assert ranks[0]["mutable"]["round_words_seen"] == ranks[1]["mutable"]["round_words_seen"] \
        == twin


@pytest.mark.parametrize("case,members,says", [
    ("max_batch", (0, 1), "max_batch"),
    ("sources", (2, 3), "other work than rank 0"),
    ("write", (0, 1), "failed on rank 0"),
])
def test_ranks_that_disagree_are_refused(spawned, case, members, says):
    """Each refusal raises ``ValueError`` on every rank of the pair, and the
    ranks go on to their next leg (no rank is left in a collective)."""
    ranks = spawned[0]
    for r in members:
        assert says in ranks[r]["refusals"][case], (r, ranks[r]["refusals"][case])
