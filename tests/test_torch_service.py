"""Port parity for the serving tier: ``ServingService``, the cohort
functions, the engine's ``ppr`` op and the tenant ledgers.

Every case of ``tests/test_service.py`` but the sharded one is run twice on
the same script: once on the JAX package's service and once on the port's,
on the same graph carried over as numpy arrays.  Tickets (status,
``finished_at``, rounds, words, estimates, results), ``stats``, ledgers and
the cohort cache's miss counts must be equal (PPR results within atol
1e-6, float sums in another order); then the case's own assertions run on
the port.  The cohort functions must equal the JAX package's bit for bit,
through the chunk loop and through the fused round's wrapper (its plain
version on the CPU).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro_torch.core.edgemap as port_edgemap
import repro_torch.kernels.compressed_spmv.ops as port_ops
from repro.algorithms import traversal_cohort_init as jcohort_init
from repro.algorithms import traversal_cohort_rounds as jcohort_rounds
from repro.core import PSAMCost as JPSAMCost
from repro.core import TenantLedgers as JTenantLedgers
from repro.core import compress as jcompress
from repro.core import edgemap_reduce_batched as jedgemap_reduce_batched
from repro.core import make_plan as jmake_plan
from repro.data import rmat_graph as jrmat_graph
from repro.obs import Registry as JRegistry
from repro.obs import noop_registry as jnoop_registry
from repro.serving import QueryEngine as JQueryEngine
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving import ServingService as JServingService
from repro_torch.algorithms import (
    bfs,
    traversal_cohort_active,
    traversal_cohort_init,
    traversal_cohort_rounds,
    wbfs,
)
from repro_torch.core import PSAMCost, TenantLedger, TenantLedgers, edgemap_reduce_batched
from repro_torch.core import make_plan
from repro_torch.kernels import compressed_stream_round_ref
from repro_torch.obs import Registry, noop_registry
from repro_torch.serving import QueryEngine, ServiceConfig, ServingService
from torch_parity import port_graph, to_np

PPR_ATOL = 1e-6   # float32 push sums in another order
_CACHE = {}


def _graphs(weighted=True, compressed=False):
    key = (weighted, compressed)
    if key not in _CACHE:
        jg = jrmat_graph(128, 512, weighted=weighted, seed=7, block_size=32)
        jg = jcompress(jg) if compressed else jg
        _CACHE[key] = (jg, port_graph(jg))
    return _CACHE[key]


def _pair(weighted=True, compressed=False, strategy=None, registries=None, **cfg):
    """The JAX service and the port's on the same graph, plan and config."""
    jg, g = _graphs(weighted, compressed)
    jplan = plan = None
    if strategy is not None:
        jplan = jmake_plan(jg, strategy=strategy, tuning=None)
        plan = make_plan(g, strategy=strategy, tuning=None)
    jreg, reg = registries or (jnoop_registry(), noop_registry())
    jsvc = JServingService(jg, plan=jplan, config=JServiceConfig(**cfg), registry=jreg)
    svc = ServingService(g, plan=plan, config=ServiceConfig(**cfg), registry=reg)
    return jsvc, svc


def _same_result(op, got, want):
    if op == "bfs":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    elif op == "wbfs":
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    else:  # ppr: (p, r, rounds)
        np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]), rtol=0, atol=PPR_ATOL)
        np.testing.assert_allclose(to_np(got[1]), np.asarray(want[1]), rtol=0, atol=PPR_ATOL)
        assert int(got[2]) == int(want[2])


def _same_ticket(t, jt):
    for f in ("id", "op", "tenant", "params", "arrival", "deadline", "status", "finished_at",
              "rounds", "words", "est_words"):
        assert getattr(t, f) == getattr(jt, f), (f, getattr(t, f), getattr(jt, f))
    assert (t.result is None) == (jt.result is None)
    if t.result is not None:
        _same_result(t.op, t.result, jt.result)


def _same_ledgers(ledgers, jledgers):
    got = {k: dict(vars(v)) for k, v in ledgers.items()}
    want = {k: dict(vars(v)) for k, v in jledgers.items()}
    assert got == want


def _same_service(svc, jsvc):
    assert svc.stats == jsvc.stats
    assert svc.engine.stats == jsvc.engine.stats
    assert svc.queue_depth == jsvc.queue_depth
    assert svc.next_deadline() == jsvc.next_deadline()
    assert svc.observed_rounds == jsvc.observed_rounds
    assert svc._round_words == jsvc._round_words
    assert (svc.cost.large_reads, svc.cost.small_ops, svc.cost.large_writes) == (
        jsvc.cost.large_reads, jsvc.cost.small_ops, jsvc.cost.large_writes)
    _same_ledgers(svc.ledgers, jsvc.ledgers)
    # the cohort cache keys (backend, mesh, B, lanes, quantum, mode) and
    # their miss counts (the JAX service's traces)
    assert svc.trace_counts == jsvc.trace_counts
    np.testing.assert_equal(svc.occupancy, jsvc.occupancy)


def _run(script, **pair_kw):
    """Run ``script(svc) -> tickets`` on both services; hold them equal."""
    jsvc, svc = _pair(**pair_kw)
    jts = script(jsvc)
    ts = script(svc)
    assert len(ts) == len(jts)
    for t, jt in zip(ts, jts):
        _same_ticket(t, jt)
    _same_service(svc, jsvc)
    return svc, ts


def _singles_equal(svc, tickets):
    g, plan = svc.engine.graph, svc.plan
    for t in tickets:
        if t.op == "bfs":
            p, lv = bfs(g, t.params["src"], plan=plan)
            assert torch.equal(t.result[0], p) and torch.equal(t.result[1], lv)
        elif t.op == "wbfs":
            assert torch.equal(t.result, wbfs(g, t.params["src"], plan=plan))


# ----------------------------------------------------------------------
# Tenant ledgers and the GBBS-equivalent work
# ----------------------------------------------------------------------
def test_tenant_ledgers_match_jax_word_for_word():
    budgets = {"a": (1000.0, 50.0), "b": 300.0}
    jl, pl = JTenantLedgers(budgets), TenantLedgers(budgets)
    script = [
        ("refill", 0.0), ("reserve", "a", 400.0), ("reserve", "b", 120.5),
        ("settle", "a", 400.0, 512.25), ("refill", 3.5), ("reserve", "c", 1e6),
        ("settle", "c", 1e6, 17.0), ("refill", 2.0), ("settle", "b", 120.5, 90.0),
        ("charge", "a", 7.0), ("refill", 40.0), ("reserve", "a", 999.0),
        ("settle", "a", 999.0, 1200.0), ("refill", 41.0),
    ]
    for step in script:
        for led in (jl, pl):
            if step[0] == "refill":
                led.refill(step[1])
            elif step[0] == "reserve":
                if led.ledger(step[1]).can_admit(step[2]):
                    led.ledger(step[1]).reserve(step[2])
            elif step[0] == "settle":
                led.ledger(step[1]).settle(step[2], step[3])
            else:
                led.charge(step[1], step[2])
        _same_ledgers(pl, jl)
        for tenant in ("a", "b", "c", "d"):
            for est in (0.0, 100.0, 700.0):
                assert pl.ledger(tenant).can_admit(est) == jl.ledger(tenant).can_admit(est)
    assert pl.total_charged() == jl.total_charged()
    assert TenantLedger() == TenantLedger(capacity=None)


def test_gbbs_equivalent_work_matches_jax():
    jg, g = _graphs(weighted=True, compressed=True)
    jc, pc = JPSAMCost(registry=jnoop_registry()), PSAMCost(registry=noop_registry())
    for c, gr in ((jc, jg), (pc, g)):
        c.charge_edgemap_batched(gr, 4)
        c.charge_filter_pack(gr, gr.num_blocks)
        c.charge_edgemap_sparse(gr, 7, batch=2)
    assert pc.work == jc.work
    for words in (0, g.m, 12345):
        assert pc.gbbs_equivalent_work(words) == jc.gbbs_equivalent_work(words)


# ----------------------------------------------------------------------
# The engine's ppr op
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compressed,strategy", [(False, "auto"), (True, "sparse_streamed")])
def test_engine_ppr_matches_jax_engine(compressed, strategy):
    jg, g = _graphs(True, compressed)
    jeng = JQueryEngine(jg, plan=jmake_plan(jg, strategy=strategy, tuning=None), max_batch=4,
                        registry=jnoop_registry())
    eng = QueryEngine(g, plan=make_plan(g, strategy=strategy, tuning=None), max_batch=4,
                      registry=noop_registry())
    reqs = [("ppr", {"src": s}) for s in (0, 9, 33)]
    reqs += [("ppr", {"src": 5, "max_rounds": 3}), ("ppr", {"src": 7, "eps": 1e-5})]
    reqs += [("bfs", {"src": 2})]
    want = jeng.serve(reqs)
    got = eng.serve(reqs)
    for (op, _), a, b in zip(reqs, got, want):
        _same_result(op, a, b)
    assert eng.stats == jeng.stats
    assert (eng.cost.large_reads, eng.cost.small_ops) == (jeng.cost.large_reads,
                                                          jeng.cost.small_ops)
    assert {k[-3:]: v for k, v in eng.trace_counts.items()} == {
        k[-3:]: v for k, v in jeng.trace_counts.items()}
    assert int(got[3][2]) == 3


# ----------------------------------------------------------------------
# Cohort functions
# ----------------------------------------------------------------------
COHORT = (["bfs", "wbfs", "bfs", "wbfs", "bfs", "bfs", "wbfs", "bfs"],
          [0, 5, 9, 17, 33, -1, 2, -1])


def _same_state(st, jst):
    assert set(st) == set(jst)
    for k in st:
        np.testing.assert_array_equal(to_np(st[k]) if k != "rnd" else st[k], np.asarray(jst[k]))


def _port_cohort(g, ops, srcs, quantum, plan):
    """The port's cohort drained quantum by quantum: the states after each
    call, with the lane rounds and activity."""
    st, w = traversal_cohort_init(g, ops, srcs)
    steps = [(st, None, None)]
    while True:
        st, lr, act = traversal_cohort_rounds(g, st, w, quantum=quantum, plan=plan)
        assert torch.equal(act, traversal_cohort_active(st, w, g.n))
        assert int(lr[5]) == 0            # the src=-1 pad lane is never active
        steps.append((st, lr, act))
        if not bool(act.any()):
            return w, steps


@pytest.mark.parametrize("quantum,lanes", [(1, "mixed"), (4, "mixed"), (4, "bfs"),
                                           (4, "wbfs")])
def test_cohort_rounds_match_jax(quantum, lanes, monkeypatch):
    """Bit for bit against the JAX cohort, through the chunk loop and
    through the fused round's wrapper (the route taken as on the card, the
    wrapper's plain version run): one fused call a round, with the map
    lanes of a mixed cohort."""
    jg, g = _graphs(True, True)
    ops, srcs = COHORT
    if lanes != "mixed":
        ops = [lanes] * len(ops)
    jplan = jmake_plan(jg, strategy="sparse_streamed", tuning=None)
    plan = make_plan(g, strategy="sparse_streamed", tuning=None)
    jst, jw = jcohort_init(jg, ops, srcs)
    jsteps = [(jst, None, None)]
    while True:
        jst, jlr, jact = jcohort_rounds(jg, jst, jw, quantum=quantum, plan=jplan)
        jsteps.append((jst, jlr, jact))
        if not bool(jnp.any(jact)):
            break
    w, chunks = _port_cohort(g, ops, srcs, quantum, plan)
    calls = []

    def counted(*args, **kwargs):
        lanes_arg = kwargs["map_lanes"]
        calls.append(None if lanes_arg is None else tuple(to_np(lanes_arg).tolist()))
        return compressed_stream_round_ref(*args, **kwargs)

    monkeypatch.setattr(port_edgemap, "kernel_route", lambda device: "cuda")
    monkeypatch.setattr(port_ops, "compressed_stream_round", counted)
    _, fused = _port_cohort(g, ops, srcs, quantum, plan)
    assert w == jw
    for steps in (chunks, fused):
        assert len(steps) == len(jsteps)
        for (st, lr, act), (jst, jlr, jact) in zip(steps, jsteps):
            _same_state(st, jst)
            if lr is not None:
                np.testing.assert_array_equal(to_np(lr), np.asarray(jlr))
                np.testing.assert_array_equal(to_np(act), np.asarray(jact))
    rounds = sum(int(lr.max()) for _, lr, _ in chunks[1:])
    assert len(calls) == rounds
    assert set(calls) == {tuple(op == "wbfs" for op in ops) if lanes == "mixed" else None}
    st = chunks[-1][0]
    for i, (op, s) in enumerate(zip(ops, srcs)):
        if s < 0:
            continue
        if op == "bfs":
            p, lv = bfs(g, s, plan=plan)
            assert torch.equal(st["parents"][i], p) and torch.equal(st["levels"][i], lv)
        else:
            assert torch.equal(st["dist"][i], wbfs(g, s, plan=plan))


def test_cohort_init_rejects_bad_lanes():
    _, g = _graphs()
    with pytest.raises(ValueError, match="cohort lanes"):
        traversal_cohort_init(g, ["bfs", "ppr"], [0, 1])
    with pytest.raises(ValueError, match="sources must be"):
        traversal_cohort_init(g, ["bfs", "wbfs"], [0])


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_streamed", "auto"])
def test_map_lanes_identity_on_unselected(mode):
    jg, g = _graphs(weighted=True, compressed=True)
    B, n = 4, g.n
    fm = np.zeros((B, n), bool)
    fm[0, :5] = True
    fm[1, 10:20] = True
    fm[2, 3] = True
    fm[3, 40:60] = True
    xs = (np.arange(B * n, dtype=np.int32).reshape(B, n) % 97)
    ml = np.array([True, False, True, False])

    def add1(x, w):
        return x + 1

    out, touched = edgemap_reduce_batched(g, torch.from_numpy(fm), torch.from_numpy(xs),
                                          map_fn=add1, map_lanes=torch.from_numpy(ml),
                                          monoid="min", mode=mode)
    jout, jtouched = jedgemap_reduce_batched(jg, jnp.asarray(fm), jnp.asarray(xs),
                                             map_fn=add1, map_lanes=jnp.asarray(ml),
                                             monoid="min", mode=mode)
    np.testing.assert_array_equal(to_np(out), np.asarray(jout))
    np.testing.assert_array_equal(to_np(touched), np.asarray(jtouched))
    on, t_on = edgemap_reduce_batched(g, torch.from_numpy(fm), torch.from_numpy(xs),
                                      map_fn=add1, monoid="min", mode=mode)
    off, _ = edgemap_reduce_batched(g, torch.from_numpy(fm), torch.from_numpy(xs),
                                    monoid="min", mode=mode)
    for b in (0, 2):
        assert torch.equal(out[b], on[b])
    for b in (1, 3):
        assert torch.equal(out[b], off[b])
    assert torch.equal(touched, t_on)


# ----------------------------------------------------------------------
# The service: each case of tests/test_service.py on both packages
# ----------------------------------------------------------------------
def test_empty_queue_ticks_are_noops():
    svc, _ = _run(lambda s: [t for now in (0.0, 1.0, 5.0) for t in s.tick(now)])
    assert svc.stats["ticks"] == 3 and svc.stats["flushes"] == 0
    assert svc.cost.large_reads == 0


def test_deadline_flush_pulls_in_later_arrivals():
    def script(s):
        first = s.submit("bfs", src=0, now=0.0)
        assert s.tick(0.02) == []
        late = s.submit("wbfs", src=9, now=0.04)
        done = s.tick(0.05)
        assert {t.id for t in done} == {first.id, late.id}
        return [first, late]

    svc, (first, late) = _run(script, slo=0.05, max_batch=8)
    assert svc.stats["deadline_flushes"] == 1 and svc.stats["depth_flushes"] == 0
    assert late.finished_at == 0.05
    _singles_equal(svc, [first, late])


def test_depth_trigger_fires_before_deadline():
    def script(s):
        ts = [s.submit("bfs", src=i, now=0.0) for i in range(4)]
        assert len(s.tick(0.0)) == 4
        return ts

    svc, ts = _run(script, slo=10.0, max_batch=4, depth_trigger=4)
    assert svc.stats["depth_flushes"] == 1 and svc.stats["deadline_flushes"] == 0
    _singles_equal(svc, ts)


def test_oversize_bucket_splits_at_max_batch_under_deadline():
    def script(s):
        ts = [s.submit("bfs", src=i, now=0.0) for i in range(6)]
        assert len(s.tick(0.011)) == 6
        return ts

    svc, ts = _run(script, slo=0.01, max_batch=4, depth_trigger=100)
    assert svc.stats["deadline_flushes"] == 1
    _singles_equal(svc, ts)


def test_single_lane_deadline_while_others_mid_round():
    def script(s):
        a = s.submit("wbfs", src=3, now=0.0)
        s.tick(0.03)
        b = s.submit("bfs", src=5, now=0.1)
        assert s.tick(0.12) == []
        assert [t.id for t in s.tick(0.13)] == [b.id]
        return [a, b]

    svc, (a, b) = _run(script, slo=0.03, max_batch=8)
    assert a.status == "done" and b.status == "done"
    assert svc.stats["deadline_flushes"] == 2


MIXED = [("bfs", 0), ("wbfs", 5), ("bfs", 9), ("wbfs", 17), ("bfs", 33)]


@pytest.mark.parametrize("quantum", [1, 3])
def test_mixed_cohort_bit_identical_to_singles(quantum):
    def script(s):
        ts = [s.submit(op, src=src, now=0.0) for op, src in MIXED]
        assert len(s.tick(0.02)) == len(MIXED)
        return ts

    svc, ts = _run(script, slo=0.01, max_batch=8, round_quantum=quantum)
    _singles_equal(svc, ts)


def test_early_exit_freezes_rounds_and_repacks():
    def script(s):
        ts = [s.submit(op, src=src, now=0.0) for op, src in MIXED[:4]]
        assert len(s.tick(0.02)) == 4
        return ts

    svc, ts = _run(script, slo=0.01, max_batch=8, round_quantum=1)
    b_rounds = [t.rounds for t in ts if t.op == "bfs"]
    w_rounds = [t.rounds for t in ts if t.op == "wbfs"]
    assert max(b_rounds) < min(w_rounds)
    assert svc.stats["repacks"] >= 1
    assert 0 < svc.occupancy < 1
    _singles_equal(svc, ts)


def test_word_attribution_conserved_and_early_exit_uncharged():
    def script(s):
        ts = [s.submit("bfs", src=0, now=0.0, tenant="a"),
              s.submit("wbfs", src=5, now=0.0, tenant="b"),
              s.submit("bfs", src=9, now=0.0, tenant="a")]
        s.tick(0.02)
        return ts

    svc, ts = _run(script, slo=0.01, max_batch=4, round_quantum=2)
    total = sum(t.words for t in ts)
    assert abs(total - svc.stats["cohort_rounds"] * svc._round_words) < 1e-6
    short = min(ts, key=lambda t: t.rounds)
    long = max(ts, key=lambda t: t.rounds)
    assert long.words > short.words
    assert abs(svc.ledgers.total_charged() - total) < 1e-6


def test_admission_rejects_over_budget_tenant():
    def script(s):
        r = s.submit("bfs", src=0, tenant="small", now=0.0)
        ok = s.submit("bfs", src=0, tenant="other", now=0.0)
        return [r, ok]

    svc, (r, ok) = _run(script, weighted=False, budgets={"small": (10.0, 0.0)})
    assert r.status == "rejected" and ok.status == "queued"
    assert svc.stats["rejected"] == 1 and svc.queue_depth == 1


def test_admission_defers_until_refill_covers():
    def script(s):
        a = s.submit("wbfs", src=1, tenant="t", now=0.0)
        d = s.submit("wbfs", src=3, tenant="t", now=0.0)
        assert (a.status, d.status) == ("queued", "deferred")
        assert [t.id for t in s.tick(0.101)] == [a.id]
        assert s.ledgers.ledger("t").available < 0
        assert s.tick(1.0) == [] and d.status == "deferred"
        assert s.tick(100.0) == [] and d.status == "queued"
        assert [t.id for t in s.tick(100.11)] == [d.id]
        return [a, d]

    svc, (a, d) = _run(script, budgets={"t": (7000.0, 2000.0)}, admission="defer", slo=0.1)
    _singles_equal(svc, [d])
    assert abs(svc.ledgers.ledger("t").charged - (a.words + d.words)) < 1e-6


def test_reserve_settles_to_actuals():
    def script(s):
        t = s.submit("bfs", src=0, tenant="t", now=0.0)
        assert s.ledgers.ledger("t").available == 1e9 - t.est_words
        s.tick(1.0)
        return [t]

    svc, (t,) = _run(script, weighted=False, budgets={"t": (1e9, 0.0)})
    led = svc.ledgers.ledger("t")
    assert abs(led.available - (1e9 - t.words)) < 1e-6
    assert abs(led.charged - t.words) < 1e-6


def test_non_traversal_ops_drain_through_engine():
    def script(s):
        t1 = s.submit("bfs", src=0, now=0.0)
        t2 = s.submit("ppr", src=4, now=0.0)
        assert {t.id for t in s.tick(0.02)} == {t1.id, t2.id}
        return [t1, t2]

    svc, (t1, t2) = _run(script, weighted=False, slo=0.01)
    assert svc.engine.stats["served"] == 1
    assert t2.words > 0 and t2.result[0].shape == (svc.engine.graph.n,)


def test_engine_stats_track_padded_lanes():
    _, g = _graphs(weighted=False)
    eng = QueryEngine(g, max_batch=8)
    for s in (0, 1, 2):
        eng.submit("bfs", src=s)
    eng.flush()
    assert (eng.stats["lanes"], eng.stats["padded"], eng.stats["served"]) == (4, 1, 3)
    assert eng.occupancy == 0.75


def test_service_occupancy_counts_inert_lane_slots():
    def script(s):
        ts = [s.submit("bfs", src=src, now=0.0) for src in (0, 9, 33)]
        s.tick(0.02)
        return ts

    svc, _ = _run(script, weighted=False, slo=0.01, max_batch=8, round_quantum=100)
    assert svc.stats["repacks"] == 0 and 0 < svc.occupancy < 1
    assert svc.stats["lane_rounds_total"] == 4 * svc.stats["cohort_rounds"]
    assert svc.stats["active_lane_rounds"] < svc.stats["lane_rounds_total"]


def test_service_steady_state_never_retraces():
    def script(s):
        ts = []
        for rep in range(3):
            ts += [s.submit(op, src=src, now=float(rep)) for op, src in MIXED[:3]]
            assert len(s.tick(float(rep) + 0.02)) == 3
        return ts

    svc, _ = _run(script, slo=0.01, max_batch=4)
    assert svc.trace_counts and all(c == 1 for c in svc.trace_counts.values())


def test_streamed_plan_stream_with_every_trigger(monkeypatch):
    """A virtual-time stream on a compressed graph under a ``sparse_streamed``
    plan (BFS, wBFS and PPR from two tenants, one under a budget, deferring)
    fires the deadline, depth and forced flushes, a defer, repacks and mixed
    cohorts; with the route taken as on the card, each cohort round is one
    fused call (the wrapper's plain version), mixed ones with map lanes,
    while PPR's float sums run the chunk loop."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs["map_lanes"] is not None)
        return compressed_stream_round_ref(*args, **kwargs)

    def script(s):
        ts, rng = [], np.random.default_rng(4)
        for i in range(24):
            op = ("bfs", "wbfs", "ppr")[i % 3]
            # PPR's observed price soon passes the capped tenant's capacity
            tenant = "capped" if i % 4 == 0 and op != "ppr" else "open"
            now = 0.0 if i < 8 else 0.004 * i   # a burst (depth), then a trickle
            ts.append(s.submit(op, src=int(rng.integers(0, 128)), tenant=tenant, now=now))
            s.tick(now)
        ts.append(s.submit("bfs", src=1, now=0.2))
        s.drain(0.2)
        s.tick(50.0)
        for now in (50.0, 100.0, 150.0):   # refills readmit the deferred ones
            s.drain(now)
        return ts

    kw = dict(compressed=True, strategy="sparse_streamed", slo=0.01, max_batch=8,
              depth_trigger=6, round_quantum=2, admission="defer",
              budgets={"capped": (12000.0, 2000.0)})
    jsvc, _ = _pair(**kw)
    jts = script(jsvc)
    monkeypatch.setattr(port_edgemap, "kernel_route", lambda device: "cuda")
    monkeypatch.setattr(port_ops, "compressed_stream_round", counted)
    _, svc = _pair(**kw)
    ts = script(svc)
    for t, jt in zip(ts, jts):
        _same_ticket(t, jt)
    _same_service(svc, jsvc)
    st = svc.stats
    assert st["deadline_flushes"] and st["depth_flushes"] and st["forced_flushes"]
    assert st["deferred"] and st["repacks"] and all(t.status == "done" for t in ts)
    assert len(calls) == st["cohort_rounds"] and any(calls)
    _singles_equal(svc, ts)


def test_service_metrics_carry_the_jax_names():
    def script(s):
        ts = [s.submit(op, src=src, now=0.0, tenant="x") for op, src in MIXED[:3]]
        ts.append(s.submit("ppr", src=4, now=0.0))
        s.tick(0.02)
        ts.append(s.submit("bfs", src=3, now=0.03, tenant="y"))
        s.drain(0.03)
        return ts

    jreg, reg = JRegistry(), Registry()
    _run(script, slo=0.01, max_batch=8, budgets={"y": (1.0, 0.0)}, registries=(jreg, reg))
    jsnap, snap = jreg.snapshot(), reg.snapshot()
    jnames = {k for k in jsnap if k.startswith("sage_service_") or k.startswith("sage_psam_")}
    assert jnames <= set(snap)
    for name in jnames:
        assert (snap[name]["kind"], snap[name]["labels"]) == (jsnap[name]["kind"],
                                                             jsnap[name]["labels"])
        if snap[name]["kind"] == "counter":
            assert snap[name]["series"] == jsnap[name]["series"], name
        elif snap[name]["kind"] == "histogram":
            assert ({k: v["count"] for k, v in snap[name]["series"].items()}
                    == {k: v["count"] for k, v in jsnap[name]["series"].items()}), name


def test_mutable_paths_are_not_ported():
    """The edit path is ported now (``tests/test_torch_delta.py`` holds it to
    JAX): a plain graph's service refuses edits as JAX's does (TypeError),
    has nothing to compact, and a ``DeltaOverlay`` is served."""
    from repro_torch.delta import DeltaOverlay

    jg, g = _graphs()
    svc = ServingService(g, registry=noop_registry())
    with pytest.raises(TypeError, match="DeltaOverlay"):
        svc.submit_edit("insert", 0, 1)
    assert svc.force_compact() is None
    msvc = ServingService(DeltaOverlay(g), registry=noop_registry())
    assert msvc.submit_edit("insert", 0, 1) and msvc.engine._backend_key == "DeltaGraph"
    with pytest.raises(ValueError, match="admission"):
        ServiceConfig(admission="drop")
