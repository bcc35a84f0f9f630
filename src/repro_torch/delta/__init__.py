"""repro_torch.delta — mutable graphs under the semi-asymmetric contract.

  DeltaOverlay         — host-side edit log: patch edges for insertions,
                         packed tombstone words (the ``edge_active`` layout)
                         for deleted base edges
  DeltaGraph           — immutable ``base ∪ delta`` snapshot with the
                         graph-backend surface: edgeMap, the filters, the
                         algorithms, QueryEngine and ServingService serve it
                         unmodified, equal to a from-scratch rebuild
  compact              — fold the overlay into a fresh CompressedCSR: the
                         subsystem's only large-memory write
  compact_write_words  — the ω-charged footprint of one compaction
  save_compacted       — atomic persistence (checkpoint/ckpt.py's step
                         directories, the JAX package's format)
  load_compacted       — restore the latest published compacted base

Queries over an overlay are priced by ``PSAMCost.charge_edgemap_overlay``;
when to compact is ``repro_torch.tuning.OverlayTrigger``; the serving
tier's edit path is ``ServingService.submit_edit`` / ``force_compact``.
"""
from .compact import compact, compact_write_words, load_compacted, save_compacted
from .overlay import DeltaGraph, DeltaOverlay

__all__ = [
    "DeltaGraph",
    "DeltaOverlay",
    "compact",
    "compact_write_words",
    "load_compacted",
    "save_compacted",
]
