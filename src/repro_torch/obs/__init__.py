"""repro_torch.obs — the metrics registry.

:class:`Registry` holds labeled counters, gauges and fixed-bucket
histograms; :func:`get_registry` / :func:`set_registry` /
:func:`use_registry` manage the process-global default, and
:func:`noop_registry` is the disabled mode.  ``QueryEngine`` records batch
shapes and cache hits here, ``PSAMCost`` mirrors every charge, and
``edgemap_reduce`` counts its dispatches by mode.
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
