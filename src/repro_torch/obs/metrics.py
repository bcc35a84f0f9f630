"""Metrics registry — labeled counters, gauges, fixed-bucket histograms.

The observability substrate every layer reports through: the engine records
batch shapes and compile-cache hits, ``edgemap_reduce`` counts its
dispatches, and ``PSAMCost`` mirrors every ``charge_*`` into labeled
counters — so the paper's analytic read model streams out *next to*
measured seconds.  Pure Python; identical to the JAX package's registry.

Design constraints, in order:

* **Near-zero overhead, exactly zero when disabled.**  Instruments are
  resolved once (``registry.counter(...)`` is get-or-create) and hot paths
  hold the instrument, so recording is one method call; with the
  :class:`NoopRegistry` installed every instrument is the same inert
  singleton and recording is one attribute lookup + an empty call.  Code
  that must do real work to produce a sample (read a clock, force a
  device sync) gates on ``registry.enabled`` first, so disabled mode is
  indistinguishable from uninstrumented code.
* **Host-side only.**  Nothing here traces: instruments take concrete
  Python/NumPy scalars; execution results are bit-identical with
  instrumentation on or off.
* **Pull-model exposition.**  ``Registry.snapshot()`` returns one nested
  dict (JSON-able); ``Registry.to_prometheus_text()`` renders the
  standard text exposition format, so any Prometheus scraper ingests the
  metrics unchanged.

Label discipline: an instrument declares its label *names* once
(``registry.counter(name, help, labels=("op", "tenant"))``) and every
record call passes them as keywords (``c.inc(1, op="bfs", tenant="t0")``).
Series are keyed by the label-value tuple in declared order.  Reading
back, ``value()`` / ``percentile()`` aggregate across all series unless a
label filter narrows them — queue-style "p99 over everything" and
"p99 for (bfs, tenant-7)" come from the same histogram.

Histograms use **fixed bucket bounds** (default: log-spaced latency
buckets, ~10% resolution per bucket): observation is O(log #buckets)
(a bisect), memory is O(#buckets) per series, and p50/p99 extraction is
exact bucket-walk arithmetic with linear interpolation inside the landing
bucket — within one bucket's width of ``numpy.quantile``.
"""
from __future__ import annotations

import bisect
import contextlib
import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "NoopRegistry",
    "exp_buckets",
    "get_registry",
    "set_registry",
    "use_registry",
    "noop_registry",
    "DEFAULT_LATENCY_BUCKETS",
]


def exp_buckets(lo: float, hi: float, per_decade: int = 24) -> tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds covering ``[lo, hi]``.

    ``per_decade`` buckets per factor of 10 — the default 24 gives
    ~10% worst-case relative resolution per bucket (``10^(1/24) ≈ 1.10``),
    tight enough that histogram-extracted p50/p99 agree with
    ``np.percentile`` on the raw samples.
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(lo * (10.0 ** (i / per_decade)) for i in range(n + 1))


# seconds: 1us .. ~100s, ~10% resolution — wide enough for both virtual-time
# queueing delays and wall-clock drains on a cold CI runner
DEFAULT_LATENCY_BUCKETS = exp_buckets(1e-6, 100.0)


class _Instrument:
    """Shared label plumbing for one named metric family."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._series: dict = {}

    def _key(self, labels: dict) -> tuple:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        try:
            return tuple(str(labels[k]) for k in self.label_names)
        except KeyError as e:
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            ) from e

    def _select(self, labels: dict) -> list:
        """Every series whose label values match the (partial) filter."""
        idx = [
            (i, str(v))
            for i, k in enumerate(self.label_names)
            for fk, v in labels.items()
            if fk == k
        ]
        unknown = set(labels) - set(self.label_names)
        if unknown:
            raise ValueError(f"{self.name}: unknown labels {sorted(unknown)}")
        return [
            s
            for key, s in self._series.items()
            if all(key[i] == v for i, v in idx)
        ]

    def series(self):
        """(label-value tuple, series-state) pairs, in insertion order."""
        return list(self._series.items())

    def reset(self) -> None:
        """Zero every series (the label sets themselves are kept)."""
        self._series.clear()


class Counter(_Instrument):
    """Monotone counter family: ``inc(value, **labels)``; never decreases."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        """Add ``value`` (≥ 0) to the series named by ``labels``."""
        if value < 0:
            raise ValueError(f"{self.name}: counters only increase ({value})")
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        """Sum over every series matching the (possibly partial) filter."""
        return float(sum(self._select(labels)))


class Gauge(_Instrument):
    """Point-in-time value family: ``set`` / ``add``; last write wins."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        """Set the series named by ``labels`` to ``value``."""
        self._series[self._key(labels)] = float(value)

    def add(self, value: float, **labels) -> None:
        """Adjust the series by ``value`` (negative allowed)."""
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        """The matching series' value (sum when the filter matches several;
        NaN when none has been set — 'no data' is not 0)."""
        sel = self._select(labels)
        return float(sum(sel)) if sel else float("nan")


class Histogram(_Instrument):
    """Fixed-bucket histogram family with exact p50/p99 bucket arithmetic.

    Each series holds per-bucket counts (``len(bounds)+1`` — the last is
    the +Inf overflow), a running sum and min/max.  ``percentile`` walks
    the cumulative counts and linearly interpolates inside the landing
    bucket (clamped to the observed min/max so single-sample series are
    exact); resolution is therefore one bucket's width.
    """

    kind = "histogram"

    def __init__(self, name, help="", labels=(), buckets=DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labels)
        self.bounds = tuple(float(b) for b in buckets)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"{name}: bucket bounds must strictly increase")

    def _new_series(self):
        return {
            "counts": [0] * (len(self.bounds) + 1),
            "sum": 0.0,
            "min": math.inf,
            "max": -math.inf,
        }

    def observe(self, value: float, **labels) -> None:
        """Record one sample into the series named by ``labels``."""
        key = self._key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._new_series()
        v = float(value)
        s["counts"][bisect.bisect_left(self.bounds, v)] += 1
        s["sum"] += v
        s["min"] = min(s["min"], v)
        s["max"] = max(s["max"], v)

    def count(self, **labels) -> int:
        """Total samples across every series matching the filter."""
        return sum(sum(s["counts"]) for s in self._select(labels))

    def sum(self, **labels) -> float:
        """Sum of all samples across every series matching the filter."""
        return float(sum(s["sum"] for s in self._select(labels)))

    def percentile(self, q: float, **labels) -> float:
        """The ``q``-th percentile (0–100) aggregated over matching series.

        Exact bucket-walk arithmetic: find the bucket holding the
        ``q``-percent rank, linearly interpolate inside it, clamp to the
        observed min/max.  NaN when no samples match.
        """
        if not 0 <= q <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        sel = self._select(labels)
        counts = [0] * (len(self.bounds) + 1)
        lo_obs, hi_obs = math.inf, -math.inf
        for s in sel:
            for i, c in enumerate(s["counts"]):
                counts[i] += c
            lo_obs = min(lo_obs, s["min"])
            hi_obs = max(hi_obs, s["max"])
        total = sum(counts)
        if total == 0:
            return float("nan")
        rank = q / 100.0 * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(lo_obs, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else hi_obs
                frac = (rank - cum) / c if c else 0.0
                est = lo + (hi - lo) * max(frac, 0.0)
                return float(min(max(est, lo_obs), hi_obs))
            cum += c
        return float(hi_obs)


class Registry:
    """Named instrument store: get-or-create, snapshot, Prometheus text.

    One registry is the process-global default (``get_registry``); tests
    and benches inject their own so runs never mix.  ``counter`` /
    ``gauge`` / ``histogram`` are idempotent — the first call creates the
    family, later calls return it (and reject a kind or label-name
    mismatch loudly, since two call sites disagreeing about a metric's
    schema is a bug worth failing on).  ``enabled`` is True; hot paths
    that must do real work to produce a sample (clock reads, device
    syncs) check it so a :class:`NoopRegistry` costs nothing.
    """

    enabled = True

    def __init__(self):
        self._metrics: dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, help, labels, **kw)
        if not isinstance(m, cls) or (
            labels and tuple(labels) != m.label_names
        ):
            raise ValueError(
                f"{name}: already registered as {m.kind} with labels "
                f"{m.label_names}"
            )
        return m

    def counter(self, name: str, help: str = "", labels: tuple = ()) -> Counter:
        """Get-or-create the counter family ``name``."""
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Gauge:
        """Get-or-create the gauge family ``name``."""
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: tuple = (),
        buckets=DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        """Get-or-create the histogram family ``name`` (fixed ``buckets``)."""
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def get(self, name: str):
        """The instrument registered under ``name``, or None."""
        return self._metrics.get(name)

    def reset(self, prefix: str | None = None) -> None:
        """Zero every series; with ``prefix``, only matching families.

        Instruments stay registered (the schema survives); only the data
        clears — what ``QueryEngine.reset_stats`` uses to reset its
        engine-scoped (``sage_engine_*``) metrics without touching the
        service's or another engine's families.
        """
        for name, m in self._metrics.items():
            if prefix is None or name.startswith(prefix):
                m.reset()

    def snapshot(self) -> dict:
        """One nested JSON-able dict of every family and series.

        ``{name: {kind, help, labels, series: {"a|b": value | hist-dict}}}``
        — series keys join label values with ``|`` (empty string for the
        unlabeled series).  Histogram series expose count/sum/min/max and
        the extracted p50/p99, so a dashboard needs no bucket math.
        """
        out: dict = {}
        for name, m in sorted(self._metrics.items()):
            fam: dict = {
                "kind": m.kind,
                "help": m.help,
                "labels": list(m.label_names),
                "series": {},
            }
            for key, s in m.series():
                skey = "|".join(key)
                if m.kind == "histogram":
                    flt = dict(zip(m.label_names, key))
                    fam["series"][skey] = {
                        "count": sum(s["counts"]),
                        "sum": s["sum"],
                        "min": s["min"],
                        "max": s["max"],
                        "p50": m.percentile(50, **flt),
                        "p99": m.percentile(99, **flt),
                    }
                else:
                    fam["series"][skey] = s
            out[name] = fam
        return out

    def to_prometheus_text(self) -> str:
        """The Prometheus text exposition format (0.0.4) for every family.

        Counters/gauges render one sample per series; histograms render
        cumulative ``_bucket{le=...}`` samples plus ``_sum`` / ``_count``
        — directly scrapeable, no exporter shim needed.
        """
        lines: list[str] = []

        def fmt_labels(names, values, extra=()):
            pairs = [
                f'{k}="{_escape(v)}"' for k, v in list(zip(names, values)) + list(extra)
            ]
            return "{" + ",".join(pairs) + "}" if pairs else ""

        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, s in m.series():
                if m.kind == "histogram":
                    cum = 0
                    for bound, c in zip(m.bounds, s["counts"]):
                        cum += c
                        lab = fmt_labels(
                            m.label_names, key, [("le", _fmt_float(bound))]
                        )
                        lines.append(f"{name}_bucket{lab} {cum}")
                    cum += s["counts"][-1]
                    lab = fmt_labels(m.label_names, key, [("le", "+Inf")])
                    lines.append(f"{name}_bucket{lab} {cum}")
                    lab = fmt_labels(m.label_names, key)
                    lines.append(f"{name}_sum{lab} {_fmt_float(s['sum'])}")
                    lines.append(f"{name}_count{lab} {cum}")
                else:
                    lab = fmt_labels(m.label_names, key)
                    lines.append(f"{name}{lab} {_fmt_float(s)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_float(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _NoopInstrument:
    """The inert instrument every :class:`NoopRegistry` family resolves to.

    Recording (``inc`` / ``set`` / ``add`` / ``observe``) discards its
    arguments; reads return the empty-registry answers (0 counts, NaN
    values) so code that unconditionally reads metrics still works.
    """

    name = "noop"
    label_names = ()

    def inc(self, value=1.0, **labels):
        """Discard the sample (disabled mode)."""

    def set(self, value, **labels):
        """Discard the sample (disabled mode)."""

    def add(self, value, **labels):
        """Discard the sample (disabled mode)."""

    def observe(self, value, **labels):
        """Discard the sample (disabled mode)."""

    def value(self, **labels):
        """NaN — a disabled registry has no data."""
        return float("nan")

    def count(self, **labels):
        """0 samples — a disabled registry has no data."""
        return 0

    def sum(self, **labels):
        """0.0 — a disabled registry has no data."""
        return 0.0

    def percentile(self, q, **labels):
        """NaN — a disabled registry has no data."""
        return float("nan")

    def series(self):
        """No series — a disabled registry has no data."""
        return []

    def reset(self):
        """Nothing to reset."""


_NOOP_INSTRUMENT = _NoopInstrument()


class NoopRegistry:
    """Disabled-mode registry: every family is the same inert singleton.

    Installing this via ``set_registry`` (or constructing components with
    ``registry=noop_registry()``) turns every hot-path record into one
    attribute lookup plus an empty call, and ``enabled=False`` lets code
    skip the work of *producing* samples (clock reads, device syncs) —
    which is what makes no-op mode indistinguishable from the
    uninstrumented baseline (the <3% / bit-exactness acceptance bars).
    """

    enabled = False

    def counter(self, name, help="", labels=()):
        """The shared no-op instrument."""
        return _NOOP_INSTRUMENT

    def gauge(self, name, help="", labels=()):
        """The shared no-op instrument."""
        return _NOOP_INSTRUMENT

    def histogram(self, name, help="", labels=(), buckets=()):
        """The shared no-op instrument."""
        return _NOOP_INSTRUMENT

    def get(self, name):
        """None — nothing is ever registered."""
        return None

    def reset(self, prefix=None):
        """Nothing to reset."""

    def snapshot(self):
        """An empty snapshot."""
        return {}

    def to_prometheus_text(self):
        """An empty exposition."""
        return ""


_NOOP_REGISTRY = NoopRegistry()
_default_registry: Registry | NoopRegistry = Registry()
_default_lock = threading.Lock()


def get_registry():
    """The process-global default registry (enabled unless swapped out).

    Components resolve their registry here when none is injected —
    ``QueryEngine`` / ``ServingService`` at construction, ``PSAMCost`` /
    ``round_loop`` per call — so one ``set_registry(noop_registry())``
    disables the whole process.
    """
    return _default_registry


def set_registry(reg):
    """Install ``reg`` as the process-global default; returns the old one."""
    global _default_registry
    with _default_lock:
        old = _default_registry
        _default_registry = reg
    return old


def noop_registry() -> NoopRegistry:
    """The shared disabled-mode registry singleton."""
    return _NOOP_REGISTRY


@contextlib.contextmanager
def use_registry(reg):
    """Temporarily install ``reg`` as the process default (context manager).

    The enabled-vs-noop parity tests run the same workload under
    ``use_registry(Registry())`` and ``use_registry(noop_registry())``
    and assert bit-identical results; benches use it to scope a
    measurement to a fresh registry without touching global state.
    """
    old = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(old)
