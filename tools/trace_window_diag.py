"""Which profiler sessions lose their first kernel records late in a
long-lived process?

Runs ``chip_smoke.py`` whole, with phase 15(d) preceded by traced runs of
the same ``sparse_streamed`` BFS on graph B under several kinds of session,
each reporting its launches, kernel records, launches without one
(``repro_torch.obs.lost_kernel_records``), the launches-to-kernel times and
the window's instants:

* ``settled`` / ``settled again``: a throwaway one-kernel session, then a
  plain ``profile()`` session (twice in a row);
* ``64 spaced kernels first``: the same, with 64 kernels 1 ms apart inside
  the window before the BFS;
* ``50 ms idle first``: the same, with 50 ms of idle time inside the window
  before the BFS;
* ``warmup schedule``: ``schedule(wait=0, warmup=1, active=1)`` with 20
  kernels during the warm-up step;
* ``raw``: a plain session;
* ``200 ms settle then session``: 200 ms of kernels under a throwaway
  session, then ``settled``'s session;
* ``trace_session``: ``repro_torch.obs.trace_session``.

Then phase 15(d) runs as the script has it.  Run from the repository's root
on a machine with one CUDA card (~12 min):

    python3 tools/trace_window_diag.py
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.obs import annotate, lost_kernel_records, trace_session  # noqa: E402

ORIGINAL = cs.trace_graph_b
OUT = os.path.join(ROOT, "build", "trace_window_diag")
ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def report(tag, path, marker="bfs"):
    with open(path) as fh:
        trace = json.load(fh)
    ev = trace["traceEvents"]
    kernels = {e["args"].get("correlation"): e for e in ev if e.get("cat") == "kernel"}
    launches = [e for e in ev if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "") and "Kernel" in e.get("name", "")]
    spans = {e["name"]: e for e in ev if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    t0 = min(e["ts"] for e in ev if "ts" in e and e.get("ph") == "X")
    lost = [e for e in launches if e["args"].get("correlation") not in kernels]
    mark = spans.get(marker)
    lead = sorted(kernels[e["args"]["correlation"]]["ts"] - e["ts"] for e in launches
                  if e["args"].get("correlation") in kernels)
    print(f"[diag] {tag}: launches {len(launches)}, kernels {len(kernels)}, lost "
          f"{lost_kernel_records(ev)}, lost after '{marker}' "
          f"{sum(1 for e in lost if mark and e['ts'] >= mark['ts'])}; lost at ts-t0 "
          f"{[round(e['ts'] - t0) for e in lost[:3]]}..{[round(e['ts'] - t0) for e in lost[-2:]]}; "
          f"first kernel at ts-t0 {round(min(k['ts'] for k in kernels.values()) - t0)}; "
          f"'{marker}' at ts-t0 {None if mark is None else round(mark['ts'] - t0)}; "
          f"launch to kernel us min/median {lead[0] if lead else None}/"
          f"{lead[len(lead) // 2] if lead else None}; instants "
          f"{[(e.get('name'), e.get('ts')) for e in ev if e.get('ph') == 'i'][:4]}", flush=True)


def throwaway(seconds=0.0):
    """A throwaway session over one kernel, or over ``seconds`` of kernels."""
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES):
        x = torch.ones(1, device="cuda")
        t = time.perf_counter()
        x.add_(1)
        while time.perf_counter() - t < seconds:
            x.add_(1)
            torch.cuda.synchronize()
        torch.cuda.synchronize()


@contextlib.contextmanager
def session(tag, settle=True, sched=False):
    if settle:
        throwaway()
    kwargs = {"schedule": schedule(wait=0, warmup=1, active=1)} if sched else {}
    prof = profile(activities=ACTIVITIES, **kwargs)
    prof.start()
    try:
        yield prof
    finally:
        torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(OUT, f"{tag.replace(' ', '_')}.{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        report(tag, path)


def diag_then_original(trace_dir, gB):
    from repro_torch.algorithms import bfs
    from repro_torch.core import make_plan

    os.makedirs(OUT, exist_ok=True)
    plan = make_plan(gB, strategy="sparse_streamed")
    s0 = cs.sources(gB, 1, cs.SEED + 21)[0]
    bfs(gB, s0, plan=plan)
    torch.cuda.synchronize()

    def run():
        with annotate("bfs"):
            bfs(gB, s0, plan=plan)
        torch.cuda.synchronize()

    def spaced(k):
        x = torch.zeros(1, device="cuda")
        for _ in range(k):
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.001)

    for tag in ("settled", "settled again"):
        with session(tag):
            run()
    with session("64 spaced kernels first"):
        with annotate("settle"):
            spaced(64)
        run()
    with session("50 ms idle first"):
        torch.cuda.synchronize()
        time.sleep(0.05)
        run()
    with session("warmup schedule", settle=False, sched=True) as prof:
        spaced(20)
        prof.step()
        run()
    with session("raw", settle=False):
        run()
    throwaway(0.2)
    with session("200 ms settle then session"):
        run()
    with trace_session(OUT, label="trace_session") as s:
        run()
    report("trace_session", s.path)
    return ORIGINAL(trace_dir, gB)


if __name__ == "__main__":
    cs.trace_graph_b = diag_then_original
    sys.exit(cs.main())
