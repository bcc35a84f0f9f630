"""Compaction — fold the overlay into a fresh ``CompressedCSR``.

The one large-memory write of the mutable-graph subsystem: the overlay's
live edge set re-encodes as a fresh compressed base in one batched pass,
charged at the PSAM's ω write premium (``PSAMCost.charge_large_write``).
The edge list is gathered and laid out on the host (``csr_host_arrays``,
as a cold load builds a graph) and compressed on the base's device, so the
result equals a from-scratch graph over the same edges field for field.

Persistence rides ``repro_torch.checkpoint.ckpt``'s atomic step-directory
save: a crash at any point of a save leaves the previous published step as
the restore target.  The checkpoint is the JAX package's: a dict of named
arrays in the reference dtypes (uint16 codes) plus the static metadata as a
JSON byte leaf, so either package loads a base the other wrote.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..checkpoint import ckpt
from ..core.compressed import CompressedCSR, compress
from ..core.convert import to_reference_arrays
from ..core.csr import CSRGraph, csr_host_arrays
from ..device import resolve_device
from ..obs import get_registry
from .overlay import DeltaOverlay

__all__ = [
    "compact",
    "compact_write_words",
    "load_compacted",
    "save_compacted",
]

# every save carries every field (an empty array when absent), so the
# checkpoint's structure never varies and restore rebuilds it from the keys
_ARRAY_KEYS = (
    "block_first",
    "deltas",
    "valid_count",
    "exc_block",
    "exc_slot",
    "exc_value",
    "block_src",
    "degrees",
    "block_weights",
)


def compact_write_words(c: CompressedCSR) -> int:
    """Large-memory words one compaction writes: the compressed footprint
    (bytes rounded up to words) plus the uncompressed weight blocks when
    weighted — what ``_block_read_words`` charges to read this graph."""
    words = -(-c.compressed_bytes // 4)
    if c.weighted:
        words += c.block_size * c.num_blocks
    return words


def compact(
    overlay: DeltaOverlay,
    *,
    cost=None,
    ckpt_dir: str | None = None,
    step: int = 0,
    keep: int = 3,
    registry=None,
) -> CompressedCSR:
    """Fold ``overlay`` into a fresh ``CompressedCSR`` base on its device.

    The live edge set is laid out with ``csr_host_arrays`` and compressed
    with ``compress``, the pipeline of a cold load; when ``cost`` is a
    ``PSAMCost`` the compacted footprint is charged as its one
    ``charge_large_write``.  ``ckpt_dir`` persists the result atomically
    (:func:`save_compacted`).  The overlay is left untouched; callers
    rebase with ``DeltaOverlay(new_base)``.
    """
    src, dst, w = overlay.live_edges()
    arrays, meta = csr_host_arrays(
        overlay.n, src, dst, w if overlay.weighted else None,
        block_size=overlay.block_size, symmetrize=False,
    )
    dev = overlay.device
    rebuilt = CSRGraph(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}, **meta)
    c = compress(rebuilt)
    del rebuilt
    words = compact_write_words(c)
    if cost is not None:
        cost.charge_large_write(words, label="compact")
    reg = registry if registry is not None else get_registry()
    if reg.enabled:
        reg.counter("sage_delta_compactions_total", "overlay compactions executed").inc()
        reg.gauge(
            "sage_delta_last_compact_write_words",
            "NVRAM words written by the most recent compaction",
        ).set(float(words))
    if ckpt_dir is not None:
        save_compacted(ckpt_dir, step, c, keep=keep)
    return c


def _ckpt_tree(c: CompressedCSR) -> dict:
    _, arrays, _ = to_reference_arrays(c)
    meta = {
        "n": c.n,
        "m": c.m,
        "num_blocks": c.num_blocks,
        "block_size": c.block_size,
        "n_exceptions": c.n_exceptions,
        "weighted": c.weighted,
    }
    tree = {
        k: np.zeros((0, 0), np.float32) if arrays[k] is None else arrays[k]
        for k in _ARRAY_KEYS
    }
    tree["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    return tree


def save_compacted(ckpt_dir: str, step: int, c: CompressedCSR, *, keep: int = 3) -> str:
    """Persist one compacted base atomically (arrays and manifest land in
    ``step_N.tmp``; one ``os.replace`` publishes the directory)."""
    return ckpt.save(ckpt_dir, step, _ckpt_tree(c), keep=keep)


def load_compacted(
    ckpt_dir: str, step: int | None = None, *, device=None
) -> tuple[CompressedCSR | None, int | None]:
    """Load a persisted compacted base onto ``device`` (default ``cuda``);
    ``(None, None)`` when none exists.

    ``step=None`` loads the latest *published* step: the ``.tmp`` directory
    of a crashed save is invisible, so recovery sees the pre-compaction
    graph until the post-compaction save's ``os.replace`` lands."""
    dev = resolve_device(device)
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            return None, None
    example = {k: 0 for k in (*_ARRAY_KEYS, "meta")}
    tree = ckpt.restore(ckpt_dir, step, example, device=dev)
    meta = json.loads(bytes(tree["meta"].cpu().numpy()))
    weighted = bool(meta["weighted"])
    c = CompressedCSR(
        block_first=tree["block_first"].to(torch.int32),
        deltas=tree["deltas"],
        valid_count=tree["valid_count"],
        exc_block=tree["exc_block"].to(torch.int32),
        exc_slot=tree["exc_slot"].to(torch.int32),
        exc_value=tree["exc_value"].to(torch.int32),
        block_src=tree["block_src"].to(torch.int32),
        degrees=tree["degrees"].to(torch.int32),
        n=int(meta["n"]),
        m=int(meta["m"]),
        num_blocks=int(meta["num_blocks"]),
        block_size=int(meta["block_size"]),
        n_exceptions=int(meta["n_exceptions"]),
        block_weights=tree["block_weights"].to(torch.float32) if weighted else None,
        weighted=weighted,
    )
    return c, step
