"""repro_torch.obs — the observability layer: metrics registry + tracing.

* :class:`Registry` holds labeled counters, gauges and fixed-bucket
  histograms; :func:`get_registry` / :func:`set_registry` /
  :func:`use_registry` manage the process-global default, and
  :func:`noop_registry` is the disabled mode (no clock read, no sync).
* :func:`trace_session` / :func:`annotate` — ``torch.profiler`` capture as
  a context manager, carrying the planner's ``sage.round`` /
  ``sage.round.sweep`` / ``sage.shard_combine`` spans, written as a
  Chrome-trace JSON; on the card a session counts its launches without a
  kernel record (:func:`lost_kernel_records`).
* ``python -m repro_torch.obs.dump`` — run a small instrumented serving
  replay (or nothing) and print the registry as Prometheus text or JSON.

What reports where: ``ServingService`` (latency, queue depth, flush causes,
admission, occupancy, the drift gauge, and over a delta overlay the
``sage_delta_*`` edit and overlay gauges); ``QueryEngine`` (batch shapes,
cache hits); ``round_loop`` (``sage_round_loop_seconds`` /
``sage_round_loop_rounds``); ``PSAMCost`` (every charge mirrored);
``edgemap_reduce`` (dispatches by mode); ``repro_torch.delta.compact``
(``sage_delta_compactions_total``, ``sage_delta_last_compact_write_words``).
"""
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    NoopRegistry,
    Registry,
    exp_buckets,
    get_registry,
    noop_registry,
    set_registry,
    use_registry,
)
from .trace import annotate, lost_kernel_records, trace_session
