"""Does a ``torch.profiler`` session keep its first kernel records when it
starts long after the previous session stopped?

Runs the same 72 small kernels (66 in-place adds on 2^20 floats, and a
comparison read by the host after every tenth) under several sessions of one
process, and reports for each the
launches whose kernel record the exported trace lacks
(``repro_torch.obs.lost_kernel_records``) and the least time from a launch
to its kernel's start (negative: a kernel placed before its own launch):

* ``raw fresh`` / ``raw right after``: plain ``profile()`` sessions early in
  the process, one right after the other;
* ``raw after GAP s`` / ``raw after GAP s, synced``: a plain session GAP
  seconds after the previous one stopped (the card kept busy without a
  profiler meanwhile), the second with ``torch.cuda.synchronize()`` before
  its start;
* ``settled after GAP s``: a throwaway one-kernel session, then a plain
  session, GAP seconds after the previous one;
* ``trace_session right after``: ``repro_torch.obs.trace_session``;
* ``child raw first session``: a second process whose first session starts
  GAP + 70 s into its life.

Run from the repository's root on a machine with a CUDA card:

    python3 tools/trace_clock_probe.py [--gap 130] [--out build/trace_clock_probe]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.obs import lost_kernel_records, trace_session  # noqa: E402

T0 = time.perf_counter()


def work(x, n=66):
    for i in range(n):
        x.add_(1)
        if i % 10 == 9:
            bool(x[0] > -1)


def report(tag, path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")
                and "Kernel" in e.get("name", "")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    lead = [e["ts"] - launches[e["args"]["correlation"]] for e in kernels
            if e["args"].get("correlation") in launches]
    print(f"{tag}: process age {time.perf_counter() - T0:.0f} s, {len(launches)} launches, "
          f"{len(kernels)} kernel records, {lost_kernel_records(events)} launches without one; "
          f"least launch-to-kernel time {min(lead) if lead else float('nan'):.3f} us",
          flush=True)


def raw(tag, x, out, sync=False, settle=False):
    if settle:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    if sync:
        torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    work(x)
    torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(out, f"raw.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    report(tag, path)


def idle(x, seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        work(x, 20)
        torch.cuda.synchronize()
        time.sleep(0.5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gap", type=float, default=130.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "trace_clock_probe"))
    ap.add_argument("--child-wait", type=float, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_clock_probe.py needs a CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    x = torch.zeros(1 << 20, device="cuda")
    if args.child_wait is not None:
        idle(x, args.child_wait)
        raw("child raw first session", x, args.out)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), f"| torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    child = subprocess.Popen([sys.executable, __file__, "--out", args.out,
                              "--child-wait", str(args.gap + 70)])
    try:
        raw("raw fresh", x, args.out)
        raw("raw right after", x, args.out)
        idle(x, args.gap)
        raw(f"raw after {args.gap:.0f} s", x, args.out)
        idle(x, args.gap)
        raw(f"raw after {args.gap:.0f} s, synced", x, args.out, sync=True)
        idle(x, args.gap)
        raw(f"settled after {args.gap:.0f} s", x, args.out, settle=True)
        with trace_session(args.out, label="probe") as sess:
            work(x)
        report("trace_session right after", sess.path)
    finally:
        rc = child.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
