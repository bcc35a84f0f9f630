"""repro_torch.tuning — the knobs of the hot path, measured on the card.

  calibrate                — time every edgeMap strategy on the card
                             (density grid × backend × chunk / batch / tile
                             knobs) and return a TuningTable
  TuningTable              — versioned, host-keyed, schema-checked JSON
                             store with interpolating density lookups
  TuningDecision           — the knob values one ExecutionPlan executes
                             (``plan.decisions``)
  default_table            — the shipped table, measured on an H100
  load_table               — load a calibrated table (or the shipped one)
  constants_decision       — the static-defaults decision (un-tuned plans)
  crossover_from_sweep, flavor_crossover_from_sweep,
  dense_frac_from_crossover — the decisions derived from sweep rows
  OverlayTrigger, constants_overlay_trigger, measured_overlay_trigger
                           — when a delta overlay's compaction pays off

CLI: ``python -m repro_torch.tuning --out build/table.json``.
"""
from .defaults import (
    DEFAULT_CHUNK_BLOCKS,
    DEFAULT_DENSE_FRAC,
    DEFAULT_EST_ROUNDS,
    DEFAULT_MAX_BATCH,
    DEFAULT_TILE_BLOCKS,
    HBM_BYTES_PER_S,
)
from .measure import calibrate, host_fingerprint
from .overlay import OverlayTrigger, constants_overlay_trigger, measured_overlay_trigger
from .table import (
    SCHEMA_VERSION,
    TuningDecision,
    TuningTable,
    constants_decision,
    crossover_from_sweep,
    default_table,
    dense_frac_from_crossover,
    flavor_crossover_from_sweep,
    hardware_model,
    load_table,
)
