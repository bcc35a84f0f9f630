"""TuningTable — versioned, host-keyed store of measured per-strategy costs.

``repro_torch.tuning.calibrate`` times every edgeMap strategy across a
frontier-density grid on the card, plus the chunk/tile/batch knobs, and this
module turns those samples into the decisions ``make_plan(strategy="auto")``
executes.  The schema is the JAX package's, so a table written there loads
here; a per-backend ``lowering`` key in it is ignored (the port has no
lowering knob: the route comes from the device).

Schema (JSON, ``schema_version`` checked strictly on load):

.. code-block:: text

    schema_version : int           — must equal SCHEMA_VERSION
    host           : {platform, device_kind, device_count, machine, python}
    hardware       : the card as nvidia-smi names it, and its HBM rate
    graph          : {n, m, block_size}             — calibration workload
    backends       : {backend name → backend entry}

    backend entry:
      density_sweep   : [{density, dense_us, sparse_us[, sparse_streamed_us],
                          dense_words, sparse_words}, ...]   (density-sorted)
      crossover_density, dense_frac, auto_sparse             (derived)
      chunk_sweep     : [{chunk_blocks, us}, ...] ; chunk_blocks (derived)
      batch_sweep     : [{B, us_per_query}, ...]  ; max_batch   (derived)
      batched_density_sweep : [{B, density, dense_us, sparse_us
                          [, sparse_streamed_us]}, ...]        (optional)
      batched_crossover_density, dense_frac_batched,
      auto_sparse_batched, batched_flavor_crossover            (derived)
      tile_sweep      : [{tile_blocks, us}, ...] ; tile_blocks (optional)

Lookups interpolate linearly in log10(density) between grid points and
clamp at the ends.  The shipped table (``default_table.json`` beside this
module) is one full calibration on an H100; a table calibrated on the
serving host takes precedence by being passed to
``make_plan(..., tuning=table)``.

Import-light on purpose (stdlib only): ``repro_torch.core.plan`` reads it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from functools import lru_cache

from .defaults import (
    DEFAULT_CHUNK_BLOCKS,
    DEFAULT_DENSE_FRAC,
    DEFAULT_MAX_BATCH,
    DEFAULT_TILE_BLOCKS,
)

SCHEMA_VERSION = 1

_REQUIRED_TOP = ("schema_version", "host", "hardware", "backends")
_REQUIRED_BACKEND = (
    "density_sweep",
    "crossover_density",
    "dense_frac",
    "chunk_blocks",
    "auto_sparse",
    "max_batch",
)
_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "default_table.json")


@dataclasses.dataclass(frozen=True)
class TuningDecision:
    """The knob values one plan executes, and where they came from.

    ``source`` is ``"measured"`` (a TuningTable supplied them) or
    ``"constants"`` (the static defaults in ``repro_torch.tuning.defaults``);
    explicit keyword overrides given to ``make_plan`` are folded in either
    way.  ``crossover_density`` is the measured dense/sparse crossover the
    ``dense_frac`` threshold was derived from; ``table_host`` /
    ``table_version`` identify the table behind a measured decision.
    ``route`` is the kernel route resolved from the graph's device
    (``"cuda"`` or ``"torch"``), never read from a table.
    """

    source: str
    backend: str
    strategy: str
    dense_frac: float
    chunk_blocks: int
    auto_sparse: str
    max_batch: int
    auto_sparse_batched: str = "sparse"
    dense_frac_batched: float | None = None
    batched_flavor_crossover: float | None = None
    tile_blocks: int = DEFAULT_TILE_BLOCKS
    route: str | None = None
    crossover_density: float | None = None
    table_host: str | None = None
    table_version: int | None = None


def crossover_from_sweep(sweep: list[dict]) -> float:
    """Density where dense becomes the cheaper strategy, from measured rows.

    ``sweep`` is a list of ``{density, dense_us, sparse_us
    [, sparse_streamed_us]}`` samples; the sparse side is the cheaper of the
    sparse flavors at each point.  The crossing is interpolated linearly in
    log10(density).  Degenerate sweeps clamp: dense cheaper everywhere → the
    lowest measured density; sparse cheaper everywhere → 1.0 (never dense).
    """
    pts = []
    for row in sweep:
        sparse = min(
            row["sparse_us"],
            row.get("sparse_streamed_us") or row["sparse_us"],
        )
        pts.append((float(row["density"]), float(row["dense_us"]) - float(sparse)))
    pts.sort()
    if not pts:
        return 1.0 / DEFAULT_DENSE_FRAC
    if pts[0][1] <= 0:  # dense already cheaper at the sparsest point
        return max(pts[0][0], 1e-6)
    for (d0, diff0), (d1, diff1) in zip(pts, pts[1:]):
        if diff1 <= 0:  # crossed between d0 and d1
            frac = diff0 / (diff0 - diff1)
            return 10 ** (math.log10(d0) + frac * (math.log10(d1) - math.log10(d0)))
    return 1.0  # sparse cheaper everywhere


def flavor_crossover_from_sweep(sweep: list[dict]) -> float | None:
    """Density below which the batched streamed union beats per-lane plain
    sparse, from measured ``{density, sparse_us, sparse_streamed_us}`` rows.

    The flip of ``sparse_streamed_us − sparse_us`` from negative to
    non-negative is log10-interpolated.  Degenerate sweeps clamp: streamed
    cheaper everywhere → 1.0; plain cheaper everywhere → 0.0.  ``None``
    when the sweep has no streamed samples (no runtime switch at all).
    """
    pts = sorted(
        (float(r["density"]), float(r["sparse_streamed_us"]) - float(r["sparse_us"]))
        for r in sweep
        if r.get("sparse_streamed_us") is not None
    )
    if not pts:
        return None
    if pts[0][1] >= 0:  # plain already cheaper at the sparsest point
        return 0.0
    for (d0, diff0), (d1, diff1) in zip(pts, pts[1:]):
        if diff1 >= 0:  # flipped between d0 and d1
            frac = -diff0 / (diff1 - diff0)
            return 10 ** (math.log10(d0) + frac * (math.log10(d1) - math.log10(d0)))
    return 1.0  # streamed cheaper everywhere


def dense_frac_from_crossover(crossover: float) -> float:
    """Beamer threshold equivalent to a measured crossover density:
    ``dense_frac = 1 / d*``, clamped to [1, 10^4]."""
    return max(1.0, min(1e4, 1.0 / max(crossover, 1e-6)))


def _interp_log_density(sweep: list[dict], key: str, density: float) -> float:
    """Linear interpolation of ``key`` over log10(density), end-clamped."""
    pts = sorted(
        (float(r["density"]), float(r[key]))
        for r in sweep
        if r.get(key) is not None
    )
    if not pts:
        raise KeyError(f"no {key!r} samples in density sweep")
    d = max(density, 1e-9)
    if d <= pts[0][0]:
        return pts[0][1]
    if d >= pts[-1][0]:
        return pts[-1][1]
    for (d0, v0), (d1, v1) in zip(pts, pts[1:]):
        if d0 <= d <= d1:
            t = (math.log10(d) - math.log10(d0)) / (math.log10(d1) - math.log10(d0))
            return v0 + t * (v1 - v0)
    return pts[-1][1]


class TuningTable:
    """Measured per-strategy costs and the decisions derived from them.

    Construct via :meth:`from_dict` / :meth:`load` (schema-checked) or let
    ``repro_torch.tuning.calibrate`` build one.  Accessors fall back to the
    static defaults for backends the table has no measurements for.
    """

    def __init__(self, data: dict):
        self._validate(data)
        self._data = data

    # -- construction / persistence ------------------------------------
    @staticmethod
    def _validate(data: dict) -> None:
        """Schema check, fail-loud: versions and required keys."""
        if not isinstance(data, dict):
            raise ValueError("tuning table must be a JSON object")
        missing = [k for k in _REQUIRED_TOP if k not in data]
        if missing:
            raise ValueError(f"tuning table missing keys: {missing}")
        ver = data["schema_version"]
        if ver != SCHEMA_VERSION:
            raise ValueError(
                f"tuning table schema_version {ver!r} != supported "
                f"{SCHEMA_VERSION} — recalibrate with this build "
                f"(stale tables are rejected, never silently reinterpreted)"
            )
        for name, entry in data["backends"].items():
            missing = [k for k in _REQUIRED_BACKEND if k not in entry]
            if missing:
                raise ValueError(f"backend {name!r} missing keys: {missing}")
            if not entry["density_sweep"]:
                raise ValueError(f"backend {name!r} has an empty density sweep")

    @classmethod
    def from_dict(cls, data: dict) -> "TuningTable":
        """Build from a parsed JSON object (validates the schema)."""
        return cls(data)

    def to_dict(self) -> dict:
        """The raw (JSON-serializable) table contents."""
        return self._data

    @classmethod
    def loads(cls, text: str) -> "TuningTable":
        """Parse a JSON string into a validated table."""
        return cls.from_dict(json.loads(text))

    def dumps(self) -> str:
        """Serialize to a JSON string (round-trips through :meth:`loads`)."""
        return json.dumps(self._data, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        """Load and schema-check a table written by :meth:`save`."""
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    def save(self, path: str) -> None:
        """Persist as JSON."""
        with open(path, "w") as fh:
            fh.write(self.dumps() + "\n")

    # -- identity ------------------------------------------------------
    @property
    def host(self) -> dict:
        """The host the measurements were taken on (platform, device...)."""
        return self._data["host"]

    @property
    def host_key(self) -> str:
        """Short host identity, e.g. ``gpu/NVIDIA H100 80GB HBM3``."""
        h = self.host
        return f"{h.get('platform', '?')}/{h.get('device_kind', '?')}"

    @property
    def hardware(self) -> dict:
        """The hardware the table was measured on, as recorded."""
        return self._data["hardware"]

    @property
    def schema_version(self) -> int:
        """The schema this table was written with (== SCHEMA_VERSION)."""
        return self._data["schema_version"]

    def backends(self) -> list[str]:
        """Backend names with measurements (e.g. ['compressed', 'csr'])."""
        return sorted(self._data["backends"])

    def _entry(self, backend: str) -> dict | None:
        return self._data["backends"].get(backend)

    # -- derived knobs (default-safe) ----------------------------------
    def dense_frac(self, backend: str) -> float:
        """Measured Beamer threshold (1 / crossover density), or the default."""
        e = self._entry(backend)
        return float(e["dense_frac"]) if e else float(DEFAULT_DENSE_FRAC)

    def crossover_density(self, backend: str) -> float | None:
        """Measured dense/sparse crossover density (None if unmeasured)."""
        e = self._entry(backend)
        return float(e["crossover_density"]) if e else None

    def chunk_blocks(self, backend: str) -> int:
        """Best measured EDGEMAPCHUNKED chunk size, or the default."""
        e = self._entry(backend)
        return int(e["chunk_blocks"]) if e else DEFAULT_CHUNK_BLOCKS

    def tile_blocks(self, backend: str) -> int:
        """Best measured whole-graph kernel tile (warps per CTA), or the default."""
        e = self._entry(backend)
        if e and e.get("tile_blocks"):
            return int(e["tile_blocks"])
        return DEFAULT_TILE_BLOCKS

    def auto_sparse(self, backend: str) -> str:
        """The sparse flavor auto's sparse branch runs: 'sparse' or
        'sparse_streamed', whichever measured cheaper."""
        e = self._entry(backend)
        return str(e["auto_sparse"]) if e else "sparse"

    def auto_sparse_batched(self, backend: str) -> str:
        """The sparse flavor for BATCHED auto rounds, measured separately:
        the streamed union runs ONE live-block loop for all B lanes while
        plain sparse runs B loops."""
        e = self._entry(backend)
        if e and e.get("auto_sparse_batched"):
            return str(e["auto_sparse_batched"])
        return self.auto_sparse(backend)

    def dense_frac_batched(self, backend: str) -> float:
        """Beamer threshold for BATCHED rounds, from the batched density
        sweep's own crossover; the single-query value for tables without it."""
        e = self._entry(backend)
        if e and e.get("dense_frac_batched") is not None:
            return float(e["dense_frac_batched"])
        return self.dense_frac(backend)

    def batched_crossover_density(self, backend: str) -> float | None:
        """Measured batched dense/sparse crossover (None if unmeasured)."""
        e = self._entry(backend)
        if e is None or e.get("batched_crossover_density") is None:
            return None
        return float(e["batched_crossover_density"])

    def batched_flavor_crossover(self, backend: str) -> float | None:
        """Mean lane density below which batched auto's sparse branch
        streams (see :func:`flavor_crossover_from_sweep`); None when
        unmeasured, and then ``auto_sparse_batched`` runs unconditionally."""
        e = self._entry(backend)
        if e is None or e.get("batched_flavor_crossover") is None:
            return None
        return float(e["batched_flavor_crossover"])

    def max_batch(self, backend: str) -> int:
        """Measured serving batch-width knee, or the default."""
        e = self._entry(backend)
        return int(e["max_batch"]) if e else DEFAULT_MAX_BATCH

    # -- interpolating cost lookup -------------------------------------
    def strategy_us(self, backend: str, strategy: str, density: float) -> float:
        """Interpolated wall time (us) of one edgeMap round of ``strategy``
        at frontier ``density`` (incident-edge fraction), from the sweep.
        Raises KeyError for unmeasured backends/strategies."""
        e = self._entry(backend)
        if e is None:
            raise KeyError(f"backend {backend!r} not in tuning table")
        return _interp_log_density(e["density_sweep"], f"{strategy}_us", density)

    def best_strategy(self, backend: str, density: float) -> str:
        """argmin strategy at ``density`` from the interpolated costs."""
        e = self._entry(backend)
        if e is None:
            raise KeyError(f"backend {backend!r} not in tuning table")
        best, best_us = None, None
        for s in ("dense", "sparse", "sparse_streamed"):
            try:
                us = self.strategy_us(backend, s, density)
            except KeyError:
                continue
            if best_us is None or us < best_us:
                best, best_us = s, us
        return best or "dense"

    # -- the plan-facing decision --------------------------------------
    def decide(self, backend: str, strategy: str = "auto") -> TuningDecision:
        """One plan's worth of knobs for ``backend``: measured when the
        table carries this backend, otherwise the constants decision."""
        e = self._entry(backend)
        if e is None:
            return constants_decision(backend, strategy)
        return TuningDecision(
            source="measured",
            backend=backend,
            strategy=strategy,
            dense_frac=self.dense_frac(backend),
            chunk_blocks=self.chunk_blocks(backend),
            auto_sparse=self.auto_sparse(backend),
            max_batch=self.max_batch(backend),
            auto_sparse_batched=self.auto_sparse_batched(backend),
            dense_frac_batched=self.dense_frac_batched(backend),
            batched_flavor_crossover=self.batched_flavor_crossover(backend),
            tile_blocks=self.tile_blocks(backend),
            crossover_density=self.crossover_density(backend),
            table_host=self.host_key,
            table_version=self.schema_version,
        )


def constants_decision(backend: str, strategy: str = "auto") -> TuningDecision:
    """The static-defaults decision (what un-tuned plans record)."""
    return TuningDecision(
        source="constants",
        backend=backend,
        strategy=strategy,
        dense_frac=float(DEFAULT_DENSE_FRAC),
        chunk_blocks=DEFAULT_CHUNK_BLOCKS,
        auto_sparse="sparse",
        max_batch=DEFAULT_MAX_BATCH,
        auto_sparse_batched="sparse",
        tile_blocks=DEFAULT_TILE_BLOCKS,
    )


@lru_cache(maxsize=1)
def default_table() -> TuningTable:
    """The shipped table (``default_table.json`` beside this module): one
    full calibration on an H100, made with
    ``python -m repro_torch.tuning --default --n 65536 --m 8388608``.
    Loaded once per process."""
    return TuningTable.load(_DEFAULT_PATH)


def load_table(path: str | None = None) -> TuningTable:
    """Load a table from ``path``, or the shipped one when None."""
    return default_table() if path is None else TuningTable.load(path)


def hardware_model(table: TuningTable | None = None) -> dict:
    """The hardware section of ``table`` (default: the shipped table)."""
    return dict((table or default_table()).hardware)
