"""The decision record behind an ``ExecutionPlan``'s knobs.

Only the constants decision exists so far: no table has been measured on
the card, and a table measured on another host does not transfer.
"""
from __future__ import annotations

import dataclasses

from .defaults import (
    DEFAULT_CHUNK_BLOCKS,
    DEFAULT_DENSE_FRAC,
    DEFAULT_MAX_BATCH,
    DEFAULT_TILE_BLOCKS,
)


@dataclasses.dataclass(frozen=True)
class TuningDecision:
    """The knob values one plan executes, and where they came from.

    ``source`` is ``"constants"`` (the static defaults in
    ``repro_torch.tuning.defaults``); explicit keyword overrides given to
    ``make_plan`` are folded in.  ``route`` is the kernel route resolved
    from the graph's device (``"cuda"`` or ``"torch"``).
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
    tile_blocks: int = DEFAULT_TILE_BLOCKS
    route: str | None = None


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
