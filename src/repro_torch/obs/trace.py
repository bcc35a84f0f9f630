"""Round-level tracing — ``torch.profiler`` capture as a reusable session.

``trace_session`` starts a profiler, runs the enclosed block and writes one
Chrome-trace JSON into a directory: host activity, plus the card's kernels
when a CUDA device is present, with the planner's ``sage.round`` /
``sage.round.sweep`` / ``sage.shard_combine`` spans and any
:func:`annotate` span.  A serving deployment wraps a window of ``tick``
calls in it and gets the per-round timeline.

One profiler runs per process: a nested ``trace_session`` yields without
starting a second one (the outer session records everything).

On the card the profiler can drop a session's first kernel records: late
in a long-lived process three sessions in seven lost their first 21 to 40
while their launches stayed in the trace, whatever ran just before (a
throwaway session, idle time inside the window, a warm-up step), and the
first session of a process lost none (``tools/trace_window_diag.py``,
``tools/trace_clock_probe.py``).  The cause lies below this module, so a
session counts the launches its trace holds no kernel record for
(``TraceSession.lost_kernels``) and warns when there are any.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, record_function

__all__ = ["trace_session", "annotate", "lost_kernel_records"]

_active = threading.local()


class TraceSession:
    """What a :func:`trace_session` yields: ``path`` is the Chrome-trace
    JSON it wrote, set when the outermost session ends; ``lost_kernels``
    the kernel launches in it with no kernel record (always 0 without the
    card)."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.path: str | None = None
        self.lost_kernels = 0


def lost_kernel_records(events: list[dict]) -> int:
    """Kernel launches among Chrome-trace ``events`` (runtime calls whose
    name holds ``Launch`` and ``Kernel``) with no kernel event of the same
    correlation id."""
    kernels = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    return sum(1 for e in events
               if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")
               and "Kernel" in e.get("name", "")
               and e.get("args", {}).get("correlation") not in kernels)


@contextlib.contextmanager
def trace_session(trace_dir: str, *, label: str | None = None):
    """Profile the enclosed block into a Chrome-trace JSON under ``trace_dir``.

    CPU activity is always captured, CUDA activity (kernels, copies) too
    when ``torch.cuda.is_available()``.  ``label`` wraps the whole session
    in one span so several sessions stay tellable apart, and names the file
    (``<label>.<pid>.<ns>.pt.trace.json``).  A session inside a session
    yields the outer one's record without a second capture.  On the card
    the session reads its own trace for launches without a kernel record.
    View the file in Perfetto or ``chrome://tracing``.
    """
    outer = getattr(_active, "session", None)
    if outer is not None:
        with annotate(label) if label else contextlib.nullcontext():
            yield outer
        return
    session = TraceSession(trace_dir)
    _active.session = session
    activities = [ProfilerActivity.CPU]
    on_card = torch.cuda.is_available()
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with annotate(label) if label else contextlib.nullcontext():
            yield session
    finally:
        _active.session = None
        if on_card:
            torch.cuda.synchronize()  # the session's kernels end inside it
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        name = f"{label or 'sage'}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
        session.path = os.path.join(trace_dir, name)
        prof.export_chrome_trace(session.path)
        if on_card:
            with open(session.path) as fh:
                session.lost_kernels = lost_kernel_records(json.load(fh)["traceEvents"])
            if session.lost_kernels:
                warnings.warn(f"{session.path}: {session.lost_kernels} kernel launches have "
                              "no kernel record in the trace", RuntimeWarning, stacklevel=3)


def annotate(label: str):
    """A named host-side span (``torch.profiler.record_function``), in the
    trace only while a :func:`trace_session` (or another profiler) runs."""
    return record_function(label)
