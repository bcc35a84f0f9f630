"""calibrate() — time every tunable knob on the card and emit a TuningTable.

One pass, one synthetic R-MAT workload (the generator the benchmarks use,
symmetrised, unweighted), both backends:

* **Chunk sweep** — at a mid-grid density, time the sparse path across
  ``chunk_blocks`` candidates; the argmin becomes the plan's chunk size
  (first, so that every later sweep times the chunk the plan will run).
* **Density sweep** — for a grid of frontier sizes, time one
  ``edgemap_reduce`` round per fixed strategy (``dense``, ``sparse``, and
  ``sparse_streamed`` where the backend streams) beside the measured edge
  density ``sum_deg(frontier) / m``.  The dense/sparse crossover gives
  ``dense_frac = 1 / d*``.
* **Batch sweep** — time ``edgemap_reduce_batched`` across widths B; the
  knee of the per-query cost (the smallest B within 10 % of the best)
  becomes the serving ``max_batch``.
* **Batched density sweep** — the same grid at B=8: its crossover gives
  ``dense_frac_batched``, its streamed/plain flip the
  ``batched_flavor_crossover``.
* **Tile sweep** (compressed backend, full mode only) — time
  ``compressed_spmv_vertex``, the whole-graph kernel, across tile sizes
  (warps per CTA on the card, each a tile of 32 blocks).

The edgeMap sweeps carry int32 vertex ids under ``min``, the state BFS and
wBFS serve, so on the card their ``sparse_streamed`` rounds are the fused
one-launch round (``core.edgemap.stream_round_route``), not the chunk loop.

Timing: one warm-up call, then the **minimum** of ``reps`` host wall times,
each ending in ``torch.cuda.synchronize()`` on the card.  A plan is chosen
on what a round really costs, Python dispatch and launches included,
because the rounds are bound by the host.  Modeled read words ride along
with each density sample.

``repro_torch.core`` is imported inside the functions: it reads this
package's ``defaults`` and ``table`` at import time.
"""
from __future__ import annotations

import platform
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from .defaults import (
    DEFAULT_CHUNK_BLOCKS,
    DEFAULT_MAX_BATCH,
    DEFAULT_TILE_BLOCKS,
    HBM_BYTES_PER_S,
)
from .table import (
    SCHEMA_VERSION,
    TuningTable,
    crossover_from_sweep,
    dense_frac_from_crossover,
    flavor_crossover_from_sweep,
)

# Frontier sizes as vertex fractions: spans BFS's first lonely round
# through the saturated mid-traversal rounds.
_DENSITY_GRID = (0.002, 0.01, 0.05, 0.2, 1.0)
_DENSITY_GRID_QUICK = (0.002, 0.05, 1.0)
_CHUNK_GRID = (64, 128, 256, 512)
_CHUNK_GRID_QUICK = (128, 256)
_BATCH_GRID = (1, 2, 4, 8, 16)
_BATCH_GRID_QUICK = (1, 4, 8)
_TILE_GRID = (4, 8, 16)


def host_fingerprint(device=None) -> dict:
    """Identity of the machine a table was measured on (keys the table)."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    return {
        "platform": "gpu" if gpu else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if gpu else "cpu",
        "device_count": torch.cuda.device_count() if gpu else 1,
        "machine": platform.machine(),
        "python": sys.version.split()[0],
    }


def _hardware(dev: torch.device) -> dict:
    """The card as ``nvidia-smi`` names it, with its power limit and the HBM
    rate bounds are computed with; ``{"name": "cpu"}`` on the CPU route."""
    if dev.type != "cuda":
        return {"name": "cpu"}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, power = (p.strip() for p in out.splitlines()[0].split(","))
    return {"name": name, "power_limit": power, "hbm_bytes_per_s": HBM_BYTES_PER_S}


def _time_us(fn, *args, reps: int = 3) -> float:
    """Min-of-reps host wall time (us) of ``fn(*args)`` after one warm-up
    call, each call ending in a device synchronise when on the card."""
    def run():
        out = fn(*args)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    run()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _frontier_for_fraction(g, frac: float, seed: int) -> np.ndarray:
    """bool[n] mask selecting ~frac of vertices (deterministic per seed)."""
    n = g.n
    k = max(1, min(n, int(round(frac * n))))
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=k, replace=False)
    mask = np.zeros(n, dtype=bool)
    mask[idx] = True
    return mask


def _measured_density(deg: np.ndarray, m: int, mask) -> float:
    """The quantity auto's predicate tests: frontier incident edges / m."""
    return float(np.sum(np.where(mask, deg, 0))) / max(1, int(m))


def _active_block_fraction(src: np.ndarray, n: int, mask) -> float:
    live = src < n
    if not live.any():
        return 0.0
    return float(np.sum(mask[src[live]])) / float(np.sum(live))


def _has_streaming(g) -> bool:
    from ..core.edgemap import _streaming_decoder

    return _streaming_decoder(g, None) is not None


def _batch_inputs(g, frac, seed, b):
    masks = np.stack([_frontier_for_fraction(g, frac, seed + i) for i in range(b)])
    xb = torch.arange(g.n, dtype=torch.int32, device=g.device)[None, :].expand(b, g.n)
    return masks, torch.from_numpy(masks).to(g.device), xb.contiguous()


def _density_sweep(g, grid, *, seed: int, reps: int, chunk_blocks: int) -> list[dict]:
    from ..core import edgemap_reduce, edgemap_round_read_words

    deg, src = g.degrees.cpu().numpy(), g.block_src.cpu().numpy()
    x0 = torch.arange(g.n, dtype=torch.int32, device=g.device)
    dense_words = float(edgemap_round_read_words(g))
    modes = ["dense", "sparse"] + (["sparse_streamed"] if _has_streaming(g) else [])
    rows = []
    for frac in grid:
        mask_np = _frontier_for_fraction(g, frac, seed)
        mask = torch.from_numpy(mask_np).to(g.device)
        row = {
            "density": max(_measured_density(deg, g.m, mask_np), 1e-6),
            "dense_words": dense_words,
            "sparse_words": dense_words * _active_block_fraction(src, g.n, mask_np),
        }
        for mode in modes:
            row[f"{mode}_us"] = _time_us(
                lambda mode=mode: edgemap_reduce(g, mask, x0, monoid="min", mode=mode,
                                                 chunk_blocks=chunk_blocks),
                reps=reps,
            )
        rows.append(row)
    rows.sort(key=lambda r: r["density"])
    return rows


def _chunk_sweep(g, grid, *, frac: float, seed: int, reps: int) -> list[dict]:
    from ..core import edgemap_reduce

    x0 = torch.arange(g.n, dtype=torch.int32, device=g.device)
    mask = torch.from_numpy(_frontier_for_fraction(g, frac, seed)).to(g.device)
    return [
        {"chunk_blocks": int(cb),
         "us": _time_us(lambda cb=cb: edgemap_reduce(g, mask, x0, monoid="min",
                                                     mode="sparse", chunk_blocks=cb),
                        reps=reps)}
        for cb in grid
    ]


def _batch_sweep(g, grid, *, frac: float, seed: int, reps: int) -> list[dict]:
    from ..core import edgemap_reduce_batched

    rows = []
    for b in grid:
        _, masks, xb = _batch_inputs(g, frac, seed, b)
        us = _time_us(lambda: edgemap_reduce_batched(g, masks, xb, monoid="min",
                                                     mode="auto"), reps=reps)
        rows.append({"B": int(b), "us_per_query": us / b})
    return rows


def _batched_density_sweep(
    g, grid, *, seed: int, reps: int, chunk_blocks: int, b: int = 8
) -> list[dict]:
    """Per-strategy batched (B-wide) round times across the density grid:
    its dense/sparse flip becomes ``dense_frac_batched`` and its
    streamed/plain flip ``batched_flavor_crossover``."""
    from ..core import edgemap_reduce_batched

    deg = g.degrees.cpu().numpy()
    modes = ["dense", "sparse"] + (["sparse_streamed"] if _has_streaming(g) else [])
    rows = []
    for frac in grid:
        masks_np, masks, xb = _batch_inputs(g, frac, seed, b)
        row = {
            "B": int(b),
            "density": max(
                float(np.mean([_measured_density(deg, g.m, m) for m in masks_np])), 1e-6
            ),
        }
        for mode in modes:
            row[f"{mode}_us"] = _time_us(
                lambda mode=mode: edgemap_reduce_batched(
                    g, masks, xb, monoid="min", mode=mode, chunk_blocks=chunk_blocks),
                reps=reps,
            )
        rows.append(row)
    rows.sort(key=lambda r: r["density"])
    return rows


def _tile_sweep(g, grid, *, reps: int) -> list[dict]:
    """Tile candidates (warps per CTA) of the whole-graph compressed kernel."""
    from ..kernels.compressed_spmv import compressed_spmv_vertex

    x0 = torch.arange(g.n, dtype=torch.float32, device=g.device)
    return [
        {"tile_blocks": int(tb),
         "us": _time_us(lambda tb=tb: compressed_spmv_vertex(g, x0, tile_blocks=tb),
                        reps=reps)}
        for tb in grid
    ]


def _knee(batch_sweep: list[dict], tol: float = 1.10) -> int:
    """Smallest B within ``tol`` of the best per-query amortization."""
    if not batch_sweep:
        return DEFAULT_MAX_BATCH
    best = min(r["us_per_query"] for r in batch_sweep)
    for r in sorted(batch_sweep, key=lambda r: r["B"]):
        if r["us_per_query"] <= tol * best:
            return int(r["B"])
    return int(batch_sweep[-1]["B"])


def _argmin(rows: list[dict], key: str, val: str, default: int) -> int:
    if not rows:
        return default
    return int(min(rows, key=lambda r: r[val])[key])


def _backend_entry(g, *, quick: bool, seed: int, reps: int, tile: bool) -> dict:
    density_grid = _DENSITY_GRID_QUICK if quick else _DENSITY_GRID
    chunk_grid = _CHUNK_GRID_QUICK if quick else _CHUNK_GRID
    batch_grid = _BATCH_GRID_QUICK if quick else _BATCH_GRID
    mid = density_grid[len(density_grid) // 2]

    chunk_sweep = _chunk_sweep(g, chunk_grid, frac=mid, seed=seed, reps=reps)
    chunk_blocks = _argmin(chunk_sweep, "chunk_blocks", "us", DEFAULT_CHUNK_BLOCKS)

    sweep = _density_sweep(g, density_grid, seed=seed, reps=reps, chunk_blocks=chunk_blocks)
    crossover = crossover_from_sweep(sweep)
    batch_sweep = _batch_sweep(g, batch_grid, frac=mid, seed=seed, reps=reps)

    # the sparse flavor auto's sparse branch runs: whichever measured
    # cheaper where sparse wins (the low-density side of the crossover)
    auto_sparse = "sparse"
    if any("sparse_streamed_us" in r for r in sweep):
        lo = [r for r in sweep if r["density"] <= crossover] or sweep[:1]
        plain = sum(r["sparse_us"] for r in lo)
        streamed = sum(r.get("sparse_streamed_us", float("inf")) for r in lo)
        if streamed < plain:
            auto_sparse = "sparse_streamed"

    batched_sweep = _batched_density_sweep(
        g, density_grid, seed=seed, reps=reps, chunk_blocks=chunk_blocks
    )
    batched_crossover = crossover_from_sweep(batched_sweep)
    flavor_crossover = flavor_crossover_from_sweep(batched_sweep)
    auto_sparse_batched = "sparse"
    if flavor_crossover is not None and flavor_crossover > 0:
        auto_sparse_batched = "sparse_streamed"

    entry = {
        "density_sweep": sweep,
        "crossover_density": crossover,
        "dense_frac": dense_frac_from_crossover(crossover),
        "chunk_sweep": chunk_sweep,
        "chunk_blocks": chunk_blocks,
        "batch_sweep": batch_sweep,
        "max_batch": _knee(batch_sweep),
        "auto_sparse": auto_sparse,
        "batched_density_sweep": batched_sweep,
        "batched_crossover_density": batched_crossover,
        "dense_frac_batched": dense_frac_from_crossover(batched_crossover),
        "auto_sparse_batched": auto_sparse_batched,
        "batched_flavor_crossover": flavor_crossover,
    }
    if tile and _has_streaming(g):
        tile_sweep = _tile_sweep(g, _TILE_GRID, reps=reps)
        entry["tile_sweep"] = tile_sweep
        entry["tile_blocks"] = _argmin(tile_sweep, "tile_blocks", "us", DEFAULT_TILE_BLOCKS)
    return entry


def _shard_sweep(g, *, reps: int) -> list[dict]:
    """Round times per shard count, on meshes of distinct devices only: the
    counts run to the number of devices of ``g``'s kind (CUDA devices on the
    card, one on the CPU), so a one-device host returns ``[]``."""
    from ..core import edgemap_reduce, make_mesh, make_plan

    dev = g.device
    nd = torch.cuda.device_count() if dev.type == "cuda" else 1
    counts = [s for s in (1, 2, 4, 8) if s <= nd]
    if counts == [1]:
        return []
    x0 = torch.arange(g.n, dtype=torch.float32, device=dev)
    mask = torch.from_numpy(_frontier_for_fraction(g, 0.2, 0)).to(dev)
    rows = []
    for s in counts:
        devices = [torch.device("cuda", i) for i in range(s)]
        plan = make_plan(g, mesh=make_mesh((s,), ("data",), devices=devices))
        gs = plan.prepare(g)

        def fn(mask, x, gs=gs, plan=plan):
            return edgemap_reduce(gs, mask, x, monoid="min", plan=plan)

        rows.append({"shards": int(s), "us": _time_us(fn, mask, x0, reps=reps)})
    return rows


def calibrate(
    *,
    n: int = 2048,
    m: int = 16384,
    quick: bool = False,
    seed: int = 0,
    reps: int = 3,
    block_size: int = 128,
    shards: bool = False,
    device=None,
) -> TuningTable:
    """Measure every knob on ``device`` (default: the card) and return the
    TuningTable.

    ``quick`` shrinks the grids (3 density points, 2 chunk candidates,
    3 batch widths, no tile sweep); full mode adds the tile sweep, which
    launches the whole-graph compressed kernel on the card.  ``shards``
    adds the shard-count sweep (``shard_sweep``), which times meshes of
    distinct devices only and so is empty on a one-device host.
    """
    from ..core import compress
    from ..data.rmat import rmat_graph

    dev = resolve_device(device)
    g = rmat_graph(n, m, seed=seed, block_size=block_size, device=dev)
    gc = compress(g)
    data = {
        "schema_version": SCHEMA_VERSION,
        "created": None,  # stamped by the CLI (host wall clock)
        "quick": bool(quick),
        "host": host_fingerprint(dev),
        "hardware": _hardware(dev),
        "graph": {"n": int(g.n), "m": int(g.m), "block_size": int(block_size)},
        "backends": {
            "csr": _backend_entry(g, quick=quick, seed=seed, reps=reps, tile=False),
            "compressed": _backend_entry(gc, quick=quick, seed=seed, reps=reps,
                                         tile=not quick),
        },
    }
    if shards:
        data["shard_sweep"] = _shard_sweep(g, reps=reps)
    return TuningTable.from_dict(data)
