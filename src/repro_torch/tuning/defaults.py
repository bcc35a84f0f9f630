"""Hand-set knobs of the hot path, each defined once.

* ``DEFAULT_DENSE_FRAC``   — the Beamer direction-optimization threshold
  (dense when the frontier's incident edges exceed ``m / dense_frac``).
* ``DEFAULT_CHUNK_BLOCKS`` — EDGEMAPCHUNKED chunk size: blocks per
  chunk-loop iteration, and ids per launch of the frontier-sparse kernel.
  It governs only the routes that run the chunk loop: ``sparse``, and
  ``sparse_streamed`` on the CPU or for a monoid, map or dtype the fused
  round does not take.  A ``sparse_streamed`` round of min over int32 with
  BFS's or wBFS's map on the card is one launch whatever its live count
  (``core.edgemap.stream_round_route``).
* ``DEFAULT_TILE_BLOCKS``  — blocks per chunk of the frontier-sparse SpMV
  (``compressed_spmv_vertex_chunked``).
* ``DEFAULT_DENSE_RANGE_BLOCKS`` — blocks per range of the dense pass,
  which decodes and reduces the graph one range at a time so that no
  more than one range of targets is held at int32 width.
* ``DEFAULT_MAX_BATCH``    — serving batch width cap (``QueryEngine``).
* ``DEFAULT_EST_ROUNDS``, ``DEFAULT_COMPACT_HYSTERESIS``,
  ``DEFAULT_OVERLAY_COST_SCALE``, ``DEFAULT_EDITS_PER_COMPACT`` — the
  serving-admission and delta-overlay constants, kept here for the modules
  that will read them.

* ``HBM_BYTES_PER_S``      — the H100 SXM's device-memory rate (NVIDIA's
  data sheet), the divisor of every bytes bound this port reports; a
  calibrated table records it beside the card's name and power limit.

There is no lowering knob: which kernel route runs is decided by the
device of the tensors (``repro_torch.device.kernel_route``), never by
a setting.  There is no assumed hardware model: the knobs that depend on
the card are measured by ``repro_torch.tuning.calibrate``.

Import-light on purpose (no torch): ``repro_torch.core`` imports it.
"""
from __future__ import annotations

DEFAULT_DENSE_FRAC = 20
DEFAULT_CHUNK_BLOCKS = 256
DEFAULT_TILE_BLOCKS = 8
DEFAULT_DENSE_RANGE_BLOCKS = 1 << 16
DEFAULT_MAX_BATCH = 8
DEFAULT_EST_ROUNDS = 8
DEFAULT_COMPACT_HYSTERESIS = 1.0
DEFAULT_OVERLAY_COST_SCALE = 1.0
DEFAULT_EDITS_PER_COMPACT = 1024
HBM_BYTES_PER_S = 3.35e12
