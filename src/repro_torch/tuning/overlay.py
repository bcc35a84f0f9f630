"""Compaction policy for delta overlays — when does the ω write pay off?

A :class:`repro_torch.delta.DeltaGraph` taxes every edge sweep with a
small-memory surcharge (patch blocks + tombstone words,
``overlay_small_words``); folding it away costs one batched large-memory
write (``ω × compact_write_words``).  The break-even rule is the
log-structured one — compact once the accumulated surcharge has paid for
the write:

    cost_scale × overlay_small_words × sweeps  ≥  hysteresis × ω × W

:class:`OverlayTrigger` is that inequality as a frozen policy object.
``constants_overlay_trigger`` builds it from the static defaults
(``cost_scale = 1``: one overlay word priced at one base read word).
``measured_overlay_trigger`` replaces the scale with a ratio timed on the
base's device: how much slower a dense sweep over the overlay is than over
its base, per overlay word.  The consumer
(``repro_torch.serving.ServingService``) only calls ``should_compact``.
"""
from __future__ import annotations

import dataclasses

from .defaults import DEFAULT_COMPACT_HYSTERESIS, DEFAULT_OVERLAY_COST_SCALE

__all__ = [
    "OverlayTrigger",
    "constants_overlay_trigger",
    "measured_overlay_trigger",
]


@dataclasses.dataclass(frozen=True)
class OverlayTrigger:
    """Break-even compaction policy for one delta overlay.

    ``overlay_cost_scale`` prices one overlay small-memory word in base
    read-word equivalents (1.0 = the analytic PSAM assumption; a measured
    trigger replaces it).  ``hysteresis`` > 1 delays compaction past
    break-even to batch more edits per ω write; < 1 compacts eagerly.
    ``source`` records where the scale came from (``"constants"`` or
    ``"measured"``).
    """

    overlay_cost_scale: float = DEFAULT_OVERLAY_COST_SCALE
    hysteresis: float = DEFAULT_COMPACT_HYSTERESIS
    source: str = "constants"

    def should_compact(self, dg, *, sweeps_since_compact: float, omega: float = 4.0) -> bool:
        """True once the overlay surcharge paid since the last compaction
        covers the next compaction's ω-weighted write.

        ``dg`` is the live snapshot; ``sweeps_since_compact`` the dense-sweep
        equivalents of edge reads served against it since the last
        compaction (the service derives it from its PSAM account).  An
        overlay with nothing folded in pays only the tombstone-word rent and
        compacts only when that rent alone covers the write."""
        paid = (
            self.overlay_cost_scale
            * float(dg.overlay_small_words)
            * max(float(sweeps_since_compact), 1.0)
        )
        return paid >= self.hysteresis * omega * float(dg.compact_write_words)


def constants_overlay_trigger() -> OverlayTrigger:
    """The static-defaults policy — no measurement."""
    return OverlayTrigger()


def measured_overlay_trigger(base, *, edits: int = 256, seed: int = 0,
                             reps: int = 3) -> OverlayTrigger:
    """Calibrate the overlay cost scale by timing real sweeps on ``base``.

    Applies ``edits`` random inserts + deletes (the JAX package's draws for
    the same seed) to a throwaway overlay over ``base``, times one dense
    edgeMap sweep over the base and over the overlay snapshot on the base's
    device (min of ``reps`` after a warm-up, ``tuning.measure._time_us``),
    and converts the slowdown into a per-overlay-word cost scale:

        scale = ((t_overlay − t_base) / t_base) × base_words / overlay_words

    clamped to [0.05, 20] so one noisy timing cannot make a never- or
    always-compact policy.
    """
    import numpy as np
    import torch

    from ..core.edgemap import edgemap_dense
    from ..core.psam import edgemap_round_read_words
    from ..delta import DeltaOverlay
    from .measure import _time_us

    rng = np.random.default_rng(seed)
    ov = DeltaOverlay(base)
    n = base.n
    src, dst, _ = ov.live_edges()  # the base's real slots, in slot order
    for _ in range(edits):
        u = int(rng.integers(0, n))
        v = int(rng.integers(0, n))
        if u != v:
            ov.insert(u, v)
        if src.size:
            j = int(rng.integers(0, src.size))
            ov.delete(int(src[j]), int(dst[j]))
    dg = ov.snapshot()

    dev = base.device
    frontier = torch.ones(n, dtype=torch.bool, device=dev)
    x = torch.arange(n, dtype=torch.float32, device=dev)

    def sweep(g):
        return edgemap_dense(g, frontier, x, monoid="min")

    t_base = _time_us(sweep, base, reps=reps)
    t_over = _time_us(sweep, dg, reps=reps)
    base_words = float(edgemap_round_read_words(base))
    over_words = float(max(dg.overlay_small_words, 1))
    raw = max(t_over - t_base, 0.0) / max(t_base, 1e-9) * base_words / over_words
    scale = float(min(max(raw, 0.05), 20.0))
    return OverlayTrigger(overlay_cost_scale=scale, source="measured")
