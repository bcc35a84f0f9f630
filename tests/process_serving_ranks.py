"""The rank side of ``tests/test_torch_process_serving.py``: what one process
of a 4-rank gloo group runs on the CPU.

Imports the port only (no JAX): a spawned rank starts from a fresh
interpreter.  The parent writes the JAX package's graphs (as numpy arrays),
the PageRank score vectors and the mutable leg's edit script to a pickle
once the ranks are starting (``torch_parity.load_payload``).  The ranks
serve on process plans and, on each group's first rank, on the in-process
plan of the same shape (a ``ShardMesh`` of CPU devices) for comparison:

* all four, a (2, 2) ``("pod", "data")`` mesh with the hierarchical sum:
  the engine on the CSR and the compressed graph, and the service stream;
* ranks 0 and 1, a (2,) mesh: the engine on the CSR graph, the mutable
  service persisting its compactions to one shared ``ckpt_dir``, and two
  refusals (ranks built with other ``max_batch``; a compaction whose write
  fails on rank 0);
* ranks 2 and 3, a (2,) mesh: the engine on the compressed graph, the
  service stream, and the third refusal (ranks that submit other sources).

Results go to ``rank<r>.pt`` as numpy; an exception to ``rank<r>.err`` and
exit code 1.  The request streams below are shared with the parent, which
runs them on the JAX package's services.
"""
import dataclasses
import datetime
import os
import pathlib
import traceback

import numpy as np
import torch
import torch.distributed as dist

from torch_parity import load_payload

COLLECTIVE_TIMEOUT_S = 60   # a collective that waits longer fails the rank
CPU = torch.device("cpu")
MAX_BATCH = 4
ENGINE_SOURCES = (0, 9, 33, 70)      # one batch of MAX_BATCH lanes an op
ENGINE_PPR = {"max_rounds": 30}
SERVICE_PPR = {"eps": 1e-7, "max_rounds": 3}
SERVICE_REQUESTS = 12
SERVICE_CFG = {"slo": 0.03, "max_batch": MAX_BATCH, "depth_trigger": 4, "round_quantum": 2,
               "admission": "defer"}
MUTABLE_CFG = {"slo": 0.01, "max_batch": MAX_BATCH, "compact_keep": 2,
               "budgets": {"b": (30.0, 100.0)}}
MUTABLE_HYSTERESIS = 0.05
MESHES = {
    "(2, 2) hierarchical": ((2, 2), ("pod", "data"), "hierarchical", (0, 1, 2, 3)),
    "(2,) flat, ranks 0-1": ((2,), ("data",), "flat", (0, 1)),
    "(2,) flat, ranks 2-3": ((2,), ("data",), "flat", (2, 3)),
}


def engine_requests(prs):
    """Four requests of each op, interleaved: one flush drains one bucket
    of ``MAX_BATCH`` lanes an op.  ``prs`` holds one score vector a source."""
    reqs = []
    for i, s in enumerate(ENGINE_SOURCES):
        reqs += [("bfs", {"src": s}), ("wbfs", {"src": s}), ("ppr", {"src": s, **ENGINE_PPR}),
                 ("pagerank_iteration", {"pr": prs[i]})]
    return reqs


def capped_budget(round_words) -> dict:
    """The capped tenant's bucket: a cold request's estimate and a half of
    capacity and of refill a unit of virtual time, so its BFS requests
    defer until later drains."""
    from repro_torch.tuning.defaults import DEFAULT_EST_ROUNDS

    words = 1.5 * round_words * DEFAULT_EST_ROUNDS / MAX_BATCH
    return {"capped": (words, words)}


def service_stream(svc, srcs):
    """A virtual-time stream of 12 over ``svc`` (either package's service):
    a burst of 4 at time 0 and 3 more 0.01 apart, a tick after each (a
    depth flush), a tick at 0.06 (a deadline flush), the last 5 at once at
    0.07 and a forced drain, then drains far later whose
    refills readmit what the capped tenant deferred.  Ops cycle BFS, wBFS,
    BFS, PPR; every third BFS comes from the capped tenant.  Returns the
    tickets."""
    ops = ("bfs", "wbfs", "bfs", "ppr")
    times = (0.0, 0.0, 0.0, 0.0, 0.01, 0.02, 0.03) + (0.07,) * 5
    tickets = []
    for i, (s, now) in enumerate(zip(srcs, times)):
        op = ops[i % 4]
        tenant = "capped" if op == "bfs" and i % 3 == 0 else "open"
        params = dict(SERVICE_PPR) if op == "ppr" else {}
        tickets.append(svc.submit(op, src=int(s), tenant=tenant, now=now, **params))
        if now < 0.07:
            svc.tick(now)
        if i == 6:
            svc.tick(0.06)
    svc.drain(0.07)
    for now in (100.0, 200.0, 300.0):
        svc.drain(now)
    return tickets


def mutable_stream(svc, script):
    """``tests/test_torch_delta.py``'s mutable stream: edits from tenants
    "a" and "b" (b under a budget that rejects some), a query every tenth
    edit, a tick after each; a last query, a drain and a forced compaction.
    Returns (tickets, admitted edits)."""
    tickets, admitted = [], []
    for i, e in enumerate(script):
        now = 0.002 * i
        if svc.submit_edit(e[0], e[1], e[2], *e[3:], tenant=("a", "b")[i % 2], now=now):
            admitted.append(e)
        if i % 10 == 0:
            tickets.append(svc.submit(("bfs", "wbfs")[(i // 10) % 2], src=i % 96, now=now,
                                      tenant="q"))
        svc.tick(now)
    tickets.append(svc.submit("bfs", src=0, now=1.0))
    svc.drain(1.0)
    svc.force_compact(1.0)
    return tickets, admitted


def rank_main(rank, world, init_file, payload_file, out_dir):
    out = pathlib.Path(out_dir)
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        torch.save(_run(rank, load_payload(payload_file)), out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def np_result(res):
    """A served result (a tensor or a tuple of tensors and ints) as a list
    of numpy arrays."""
    parts = res if isinstance(res, tuple) else (res,)
    return [p.numpy().copy() if isinstance(p, torch.Tensor) else np.asarray(p) for p in parts]


def _devices(res) -> set:
    parts = res if isinstance(res, tuple) else (res,)
    return {str(p.device) for p in parts if isinstance(p, torch.Tensor)}


def ticket_record(t) -> dict:
    """A ticket's fields, its result as numpy."""
    rec = {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "result"}
    rec["result"] = None if t.result is None else np_result(t.result)
    return rec


def service_record(svc, tickets) -> dict:
    """What two services of one stream must hold equal: tickets, stats,
    ledgers, cohort cache misses, the PSAM account and the read quantum."""
    return {
        "tickets": [ticket_record(t) for t in tickets],
        "stats": dict(svc.stats), "engine_stats": dict(svc.engine.stats),
        "ledgers": {k: dict(vars(v)) for k, v in svc.ledgers.items()},
        "trace_counts": dict(svc.trace_counts),
        "cost": (svc.cost.large_reads, svc.cost.small_ops, svc.cost.large_writes),
        "round_words": svc._round_words, "observed_rounds": dict(svc.observed_rounds),
        "devices": sorted({d for t in tickets if t.result is not None
                           for d in _devices(t.result)}),
    }


def _graphs(payload):
    from repro_torch.core import from_reference_arrays

    return {name: from_reference_arrays(*arrays, CPU)
            for name, arrays in payload["graphs"].items()}


def _meshes(rank):
    """This rank's process meshes, in the order every rank makes them, and
    each one's in-process twin (a ``ShardMesh`` of CPU devices)."""
    from repro_torch.core import make_mesh, make_process_mesh

    out = {}
    for name, (shape, axes, reduce_mode, ranks) in MESHES.items():
        if rank not in ranks:
            continue
        group = None if len(ranks) == dist.get_world_size() else dist.new_group(
            list(ranks), use_local_synchronization=True)
        mesh = make_process_mesh(shape, axes, group=group, device=CPU)
        twin = make_mesh(shape, axes, devices=[CPU] * len(ranks))
        out[name] = (mesh, twin, reduce_mode)
    return out


def _engine(g, mesh, reduce_mode, prs):
    """The engine's one flush of every op on a process plan, each lane's
    single-query run on the same plan, and the knobs it agreed on."""
    from repro_torch.algorithms import (
        bfs,
        pagerank_iteration,
        personalized_pagerank,
        wbfs,
    )
    from repro_torch.core import make_plan
    from repro_torch.obs import noop_registry
    from repro_torch.serving import QueryEngine

    plan = make_plan(g, mesh=mesh, reduce_mode=reduce_mode, tuning=None)
    eng = QueryEngine(g, plan=plan, max_batch=MAX_BATCH, registry=noop_registry())
    reqs = engine_requests(prs)
    got = eng.serve(reqs)
    gs = eng.prepared
    single = []
    for op, p in reqs:
        if op == "bfs":
            single.append(bfs(gs, p["src"], plan=plan))
        elif op == "wbfs":
            single.append(wbfs(gs, p["src"], plan=plan))
        elif op == "ppr":
            single.append(personalized_pagerank(gs, p["src"], plan=plan, **ENGINE_PPR))
        else:
            single.append(pagerank_iteration(gs, p["pr"], plan=plan))
    return {"results": [np_result(r) for r in got], "single": [np_result(r) for r in single],
            "devices": sorted({d for r in got for d in _devices(r)}),
            "stats": dict(eng.stats), "trace_counts": dict(eng.trace_counts),
            "cost": (eng.cost.large_reads, eng.cost.small_ops),
            "shards": (gs.shard_index, len(gs.shards), gs.num_shards)}


def _service(g, mesh, reduce_mode, srcs, cfg_extra=None):
    from repro_torch.core import make_plan
    from repro_torch.obs import noop_registry
    from repro_torch.serving import ServiceConfig, ServingService

    plan = make_plan(g, mesh=mesh, reduce_mode=reduce_mode, tuning=None)
    words = plan.edge_read_words_per_round(plan.prepare(g))
    cfg = ServiceConfig(**SERVICE_CFG, budgets=capped_budget(words), **(cfg_extra or {}))
    svc = ServingService(g, plan=plan, config=cfg, registry=noop_registry())
    return service_record(svc, service_stream(svc, srcs))


def _mutable(g, mesh, ckpt_dir, script):
    """The mutable stream over ``DeltaOverlay(g)`` on a plan over ``mesh``,
    its compactions persisted to ``ckpt_dir``; counts this process's
    ``save_compacted`` calls."""
    import repro_torch.serving.service as service_mod
    from repro_torch.core import make_plan
    from repro_torch.delta import DeltaOverlay
    from repro_torch.obs import noop_registry
    from repro_torch.serving import ServiceConfig, ServingService
    from repro_torch.tuning import OverlayTrigger

    ov = DeltaOverlay(g)
    plan = None if mesh is None else make_plan(ov.snapshot(), mesh=mesh, tuning=None)
    cfg = ServiceConfig(**MUTABLE_CFG, ckpt_dir=ckpt_dir,
                        compact_trigger=OverlayTrigger(hysteresis=MUTABLE_HYSTERESIS))
    saves, real = [], service_mod.save_compacted

    def counted(*a, **kw):
        saves.append(a[1])
        return real(*a, **kw)

    service_mod.save_compacted = counted
    try:
        svc = ServingService(ov, plan=plan, config=cfg, registry=noop_registry())
        rounds = [svc._round_words]
        tickets, admitted = mutable_stream(svc, script)
        rounds.append(svc._round_words)
    finally:
        service_mod.save_compacted = real
    rec = service_record(svc, tickets)
    rec.update(admitted=admitted, saves=saves, round_words_seen=rounds,
               compact_step=svc._compact_step, edits_per_compact=svc._edits_per_compact,
               base=_arrays(svc.overlay.base))
    return rec


def _arrays(c) -> dict:
    from repro_torch.core import to_reference_arrays

    _, arrays, meta = to_reference_arrays(c)
    return {"arrays": {k: None if v is None else np.asarray(v) for k, v in arrays.items()},
            "meta": meta}


def _refused(fn) -> str:
    """The ``ValueError`` ``fn`` raises, or "" when it returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _run(rank, payload):
    from repro_torch.delta import DeltaOverlay, load_compacted
    from repro_torch.core import make_plan
    from repro_torch.obs import noop_registry
    from repro_torch.serving import ServiceConfig, ServingService

    graphs = _graphs(payload)
    prs = [torch.from_numpy(p) for p in payload["prs"]]
    srcs = payload["service_sources"]
    out = {"rank": rank, "engine": {}, "service": {}, "twin": {}, "refusals": {}}
    for name, (mesh, twin, reduce_mode) in _meshes(rank).items():
        first = mesh.rank == 0
        kinds = {"(2, 2) hierarchical": ("csr", "compressed"),
                 "(2,) flat, ranks 0-1": ("csr",),
                 "(2,) flat, ranks 2-3": ("compressed",)}[name]
        for kind in kinds:
            out["engine"][name, kind] = _engine(graphs[kind], mesh, reduce_mode, prs)
            if first:
                out["twin"]["engine", name, kind] = _engine(graphs[kind], twin, reduce_mode, prs)
        if name != "(2,) flat, ranks 0-1":
            out["service"][name] = _service(graphs["csr"], mesh, reduce_mode, srcs)
            if first:
                out["twin"]["service", name] = _service(graphs["csr"], twin, reduce_mode, srcs)
        if name == "(2,) flat, ranks 0-1":
            gm = graphs["mutable"]
            rec = _mutable(gm, mesh, payload["ckpt_dir"], payload["script"])
            # every rank reloads the newest persisted step: its own fold's base
            loaded, step = load_compacted(payload["ckpt_dir"], device=CPU)
            rec["reloaded"] = (step, _arrays(loaded))
            out["mutable"] = rec
            if first:
                out["twin"]["mutable"] = _mutable(gm, twin, None, payload["script"])
            plan = make_plan(graphs["csr"], mesh=mesh, tuning=None)
            out["refusals"]["max_batch"] = _refused(lambda: ServingService(
                graphs["csr"], plan=plan, config=ServiceConfig(max_batch=4 * (1 + mesh.rank)),
                registry=noop_registry()))

            def failing_write():
                ov = DeltaOverlay(gm)
                svc = ServingService(ov, plan=make_plan(ov.snapshot(), mesh=mesh, tuning=None),
                                     config=ServiceConfig(ckpt_dir=payload["not_a_dir"]),
                                     registry=noop_registry())
                svc.submit_edit("insert", 1, 2)
                svc.force_compact()

            out["refusals"]["write"] = _refused(failing_write)
        if name == "(2,) flat, ranks 2-3":
            plan = make_plan(graphs["csr"], mesh=mesh, tuning=None)

            def other_sources():
                svc = ServingService(graphs["csr"], plan=plan, config=ServiceConfig(),
                                     registry=noop_registry())
                svc.submit("bfs", src=mesh.rank, now=0.0)
                svc.drain(0.0)

            out["refusals"]["sources"] = _refused(other_sources)
    return out
