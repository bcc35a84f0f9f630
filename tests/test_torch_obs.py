"""Port parity for the observability layer: ``repro_torch.obs.trace``, the
planner's round spans and ``_eager_round_loop_observer``, and the
``repro_torch.obs.dump`` CLI, on the CPU.

``trace_session`` writes a Chrome-trace JSON holding one ``sage.round``
span a round (``sage.round.sweep`` a shard and ``sage.shard_combine`` a
round on a sharded plan); the round-loop histograms record the same
rounds as the JAX package's eager observer on the same graph; results are
bit-identical with a live registry and under ``noop_registry()`` (which
reads no clock and syncs nothing); and the dump prints the JAX dump's
metric families with equal admission counters.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.algorithms import bfs as jbfs
from repro.algorithms import pagerank as jpagerank
from repro.data import rmat_graph as jrmat_graph
from repro.obs import Registry as JRegistry
from repro.obs import use_registry as juse_registry
from repro.obs.dump import main as jdump_main
import repro_torch.core.plan as port_plan
from repro_torch.algorithms import bfs, pagerank, wbfs
from repro_torch.core import compress, make_mesh, make_plan
from repro_torch.obs import (
    Registry,
    annotate,
    lost_kernel_records,
    noop_registry,
    trace_session,
    use_registry,
)
from repro_torch.serving import QueryEngine
from torch_parity import port_graph, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = {}


def _graphs():
    if "g" not in _CACHE:
        jg = jrmat_graph(256, 1024, weighted=True, seed=3, block_size=32)
        _CACHE["g"] = (jg, port_graph(jg))
    return _CACHE["g"]


def _events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _spans(events, name):
    return [e for e in events if e.get("name") == name and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _bfs_rounds(levels) -> int:
    """Rounds a BFS ran: one a level, plus the round that finds nothing."""
    return int(to_np(levels).max()) + 1


def test_trace_session_writes_round_spans(tmp_path):
    _, g = _graphs()
    plan = make_plan(g, strategy="sparse", tuning=None)
    with use_registry(Registry()) as reg, trace_session(str(tmp_path)) as sess:
        _, levels = bfs(g, 0, plan=plan)
    assert sess.path is not None and os.path.dirname(sess.path) == str(tmp_path)
    assert os.listdir(tmp_path) == [os.path.basename(sess.path)]
    events = _events(sess.path)
    rounds = _bfs_rounds(levels)
    assert len(_spans(events, "sage.round")) == rounds
    assert reg.get("sage_round_loop_rounds").sum() == float(rounds)
    # a sharded plan: a local sweep span a shard, a combine span a round
    mesh = make_mesh((2,), ("data",), devices=[torch.device("cpu")] * 2)
    splan = make_plan(g, mesh=mesh, strategy="sparse", tuning=None)
    with trace_session(str(tmp_path / "sharded")) as sess2:
        _, slevels = bfs(g, 0, plan=splan)
    assert torch.equal(slevels, levels)
    events = _events(sess2.path)
    assert len(_spans(events, "sage.round")) == rounds
    assert len(_spans(events, "sage.round.sweep")) == 2 * rounds
    assert len(_spans(events, "sage.shard_combine")) == rounds


def test_lost_kernel_records_counts_launches_without_a_kernel(tmp_path):
    def launch(name, corr):
        return {"cat": "cuda_runtime", "name": name, "ph": "X", "args": {"correlation": corr}}

    def kernel(corr):
        return {"cat": "kernel", "name": "k", "ph": "X", "args": {"correlation": corr}}

    events = [launch("cudaLaunchKernel", 1), kernel(1), launch("cuLaunchKernelEx", 2),
              launch("cudaLaunchKernelExC", 3), kernel(3), launch("cudaMemcpyAsync", 4),
              launch("cudaLaunchKernel", 5), {"cat": "cpu_op", "name": "aten::add_"}]
    assert lost_kernel_records(events) == 2          # correlations 2 and 5
    assert lost_kernel_records(events + [kernel(2), kernel(5)]) == 0
    # a session without the card counts nothing
    _, g = _graphs()
    with trace_session(str(tmp_path)) as sess:
        bfs(g, 0)
    assert sess.lost_kernels == 0 == lost_kernel_records(_events(sess.path))


def test_nested_session_and_annotate(tmp_path):
    _, g = _graphs()
    outer_dir, inner_dir = tmp_path / "outer", tmp_path / "inner"
    with trace_session(str(outer_dir), label="outer") as outer:
        with trace_session(str(inner_dir), label="inner") as inner:
            assert inner is outer
            with annotate("test.flush"):
                bfs(g, 1)
    assert not inner_dir.exists()
    assert len(os.listdir(outer_dir)) == 1 and os.path.basename(outer.path).startswith("outer.")
    events = _events(outer.path)
    for name in ("outer", "inner", "test.flush", "sage.round"):
        assert _spans(events, name), name
    # after the outer session ends a new one captures again
    with trace_session(str(inner_dir)) as again:
        bfs(g, 1)
    assert again is not outer and os.path.exists(again.path)


@pytest.mark.parametrize("algorithm", ["bfs", "wbfs", "pagerank"])
def test_round_loop_metrics_match_jax(algorithm):
    """The port's round-loop histograms hold what JAX's eager observer holds
    for the same calls: one call each, the rounds of the largest 0-d
    integer leaf (BFS's round counter, PageRank's iterations; wBFS's state
    has none)."""
    from repro.algorithms import wbfs as jwbfs

    jg, g = _graphs()
    calls = {
        "bfs": (lambda: bfs(g, 0), lambda: jbfs(jg, 0)),
        "wbfs": (lambda: wbfs(g, 5), lambda: jwbfs(jg, 5)),
        "pagerank": (lambda: pagerank(g, max_iters=12), lambda: jpagerank(jg, max_iters=12)),
    }[algorithm]
    reg, jreg = Registry(), JRegistry()
    for src_call, registry, use in ((calls[0], reg, use_registry), (calls[1], jreg,
                                                                      juse_registry)):
        for _ in range(2):
            with use(registry):
                out = src_call()
    if algorithm == "bfs":
        assert _bfs_rounds(out[1]) == int(np.asarray(jbfs(jg, 0)[1]).max()) + 1
    seconds, jseconds = reg.get("sage_round_loop_seconds"), jreg.get("sage_round_loop_seconds")
    assert seconds.count(path="sequential") == jseconds.count(path="sequential") == 2
    rounds, jrounds = reg.get("sage_round_loop_rounds"), jreg.get("sage_round_loop_rounds")
    if jrounds is None:
        assert rounds is None
        return
    assert rounds.count() == jrounds.count() == 2 and rounds.sum() == jrounds.sum()
    assert [s["counts"] for _, s in rounds.series()] == [s["counts"] for _, s in
                                                           jrounds.series()]


def test_results_bit_identical_enabled_vs_noop(monkeypatch):
    jg, g = _graphs()
    gc = compress(g)
    plan = make_plan(gc, strategy="sparse_streamed", tuning=None)

    def run():
        out = list(bfs(gc, 3, plan=plan)) + [wbfs(gc, 3, plan=plan), pagerank(g, max_iters=8)[0]]
        eng = QueryEngine(gc, plan=plan, max_batch=8)
        for r in eng.serve([("bfs", {"src": s}) for s in range(5)] + [("wbfs", {"src": 9})]):
            out += list(r) if isinstance(r, tuple) else [r]
        return out

    with use_registry(Registry()) as reg:
        on = run()
    assert reg.get("sage_round_loop_rounds").count() > 0

    def no_clock(*a, **k):
        raise AssertionError("noop mode read the clock or synced")

    with use_registry(noop_registry()):
        assert port_plan._eager_round_loop_observer((0, torch.zeros(2))) is None
        monkeypatch.setattr(port_plan.time, "perf_counter", no_clock)
        monkeypatch.setattr(torch.cuda, "synchronize", no_clock)
        off = run()
        monkeypatch.undo()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


def _admission(text: str) -> list:
    return sorted(line for line in text.splitlines()
                  if line.startswith("sage_service_admission_total{"))


def test_dump_cli_matches_jax_families():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.dump", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": "src"},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    buf = io.StringIO()
    with juse_registry(JRegistry()), contextlib.redirect_stdout(buf):
        assert jdump_main([]) == 0
    want = buf.getvalue()
    assert _families(r.stdout) == _families(want)
    assert _admission(r.stdout) == _admission(want) and _admission(want)
    for name in ("sage_service_latency_seconds", "sage_psam_large_read_words_total"):
        assert name in r.stdout
