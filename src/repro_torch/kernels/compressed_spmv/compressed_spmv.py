"""The compressed-block kernels: wrappers and dispatch.

Three kernels share one CUDA source (``csrc/compressed_spmv.cu``):

* ``compressed_chunked_spmv`` is the port of ``compressed_chunked_spmv_pallas``.
  Given one chunk of the compacted live-block id list it decodes only those
  blocks (``emit="decode"``: masked targets plus the aligned weight tile, the
  chunk pool of EDGEMAPCHUNKED) or sums their masked weighted gather
  (``emit="sums"``, single query or a (B, n) batch decoded once per block).
* ``compressed_stream_round`` runs what the TPU runs as a loop of
  ``compressed_chunked_spmv_pallas`` launches and the chunk loop's body
  around them, for a ``sparse_streamed`` round of min over int32 with the
  identity map (BFS) or the saturating add (wBFS): liveness, decode and the
  min, one launch for the whole round, no host read of the live count.
* ``compressed_block_spmv`` is the port of ``compressed_block_spmv_pallas``:
  the same fused decode and masked weighted gather-sum over every block of
  the graph, (NB,) or (NB, B), with ``tile_blocks`` warps per CTA, each
  warp a tile of 32 blocks (4 for a batch).

Dispatch follows the device of the graph tensors and nothing else: CUDA
tensors launch the hand-written kernel (built for ``sm_90a`` on first use),
CPU tensors run the plain PyTorch version in ``ref.py``.  A CUDA call that
the kernel cannot take raises; nothing falls back.

Unlike the TPU wrappers, nothing is padded or pre-gathered: a warp loads its
block row directly, the chunked kernel treats ``id >= NB`` as an
all-sentinel row, and the block kernel's last CTA bounds-checks its warps,
so a call copies no graph array.

Each wrapper's ``launches`` counts its kernel launches (a plain integer,
bumped once per launch and nowhere else).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ...core.primitives import INF_I32
from ...device import kernel_route
from ...tuning.defaults import DEFAULT_TILE_BLOCKS
from ..build import (
    BLOCK_SIZES,
    check_launch,
    check_operand,
    check_tile_blocks,
    data_ptr,
    load_library,
    sums_output,
)
from .ref import (
    compressed_block_spmv_ref,
    compressed_chunked_spmv_ref,
    compressed_stream_round_ref,
)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "compressed_spmv.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_CHUNKED_ARGTYPES = [
    _P, _I, _P, _P, _P, _P, _P, _P,   # ids, C, first, deltas, valid_count, bits, active, w
    _I, _I, _I, _I,                   # NB, FB, n, mode
    _P, _I, _L,                       # x, B, x row stride
    _P, _P, _P, _P,                   # dst_out, w_out, sums_out, stream
]
_BLOCK_ARGTYPES = [
    _P, _P, _P, _P, _P, _P,           # first, deltas, valid_count, bits, active, w
    _I, _I, _I, _I, _I,               # NB, FB, n, mode, warps per CTA
    _P, _I, _L,                       # x, B, x row stride
    _P, _P,                           # sums_out, stream
]
_ROUND_ARGTYPES = [
    _P, _P, _P, _P, _P, _P, _P, _P,   # src, first, deltas, valid_count, active, w, exc_row, exact
    _I, _I, _I, _I,                   # NB, FB, n, map
    _P, _L, _P, _L,                   # frontier, its row stride, x, its row stride
    _P, _I,                           # map_lanes, B
    _P, _P, _P,                       # out, touched, stream
]
_MODE_DECODE, _MODE_SUMS_F32, _MODE_SUMS_I32, _MODE_SUMS_I32_W = 0, 1, 2, 3
ROUND_MAPS = {"identity": 0, "sat_add_i32": 1}  # the maps the fused round applies


def _entry(name, argtypes):
    fn = getattr(load_library(SOURCE), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_graph(block_first, deltas, valid_count, bits, edge_active, block_weights):
    """Check the graph operands the kernels share; returns (NB, FB, device)."""
    dev = deltas.device
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be (NB, FB), got {tuple(deltas.shape)}")
    NB, FB = deltas.shape
    if FB not in BLOCK_SIZES:
        raise ValueError(f"block size {FB} not supported by the kernel ({BLOCK_SIZES})")
    S = FB // 32  # slots per lane, and packed mask words per block
    check_operand("deltas", deltas, (torch.int16, torch.uint16), (NB, FB), dev, align=2 * S)
    check_operand("block_first", block_first, (torch.int32,), (NB,), dev)
    check_operand("valid_count", valid_count, (torch.int16, torch.uint16), (NB,), dev,
                  align=2)
    for name, t in (("bits", bits), ("edge_active", edge_active)):
        if t is not None:
            check_operand(name, t, (torch.int32,), (NB, S), dev)
    if block_weights is not None:
        check_operand("block_weights", block_weights, (torch.float32,), (NB, FB), dev,
                      align=4 * S)
    return NB, FB, dev


def _sums_mode(x, weighted) -> int:
    if x.dtype == torch.float32:
        return _MODE_SUMS_F32
    return _MODE_SUMS_I32_W if weighted else _MODE_SUMS_I32


def _launch_chunked(x, ids, block_first, deltas, valid_count, bits, edge_active,
                    block_weights, n, emit):
    NB, FB, dev = _check_graph(block_first, deltas, valid_count, bits, edge_active,
                               block_weights)
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D, got {tuple(ids.shape)}")
    C = ids.shape[0]
    check_operand("ids", ids, (torch.int32,), (C,), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if emit == "decode":
        dst = torch.empty((C, FB), dtype=torch.int32, device=dev)
        w = torch.empty((C, FB), dtype=torch.float32, device=dev)
        mode, x_ptr, B, stride, sums, result = _MODE_DECODE, None, 1, 0, None, (dst, w)
    else:
        B, stride, sums = sums_output(x, n, dev, C)
        mode = _sums_mode(x, block_weights is not None)
        x_ptr, dst, w, result = x.data_ptr(), None, None, sums
    if C == 0:
        return result
    status = _entry("compressed_chunked_spmv_launch", _CHUNKED_ARGTYPES)(
        ids.data_ptr(), C, block_first.data_ptr(), deltas.data_ptr(),
        valid_count.data_ptr(), data_ptr(bits), data_ptr(edge_active),
        data_ptr(block_weights), NB, FB, n, mode, x_ptr, B, stride, data_ptr(dst),
        data_ptr(w), data_ptr(sums), stream,
    )
    check_launch(status, "compressed_chunked_spmv")
    compressed_chunked_spmv.launches += 1
    return result


def compressed_chunked_spmv(
    x: torch.Tensor | None,
    ids: torch.Tensor,
    block_first: torch.Tensor,
    deltas: torch.Tensor,
    valid_count: torch.Tensor,
    bits: torch.Tensor | None = None,
    edge_active: torch.Tensor | None = None,
    block_weights: torch.Tensor | None = None,
    *,
    n: int,
    emit: str = "sums",
):
    """Frontier-sparse chunked mode: decode or sum ONLY the blocks in ``ids``.

    Same signature and results as ``compressed_chunked_spmv_ref`` (decode
    exactly; sums up to float summation order).  CUDA tensors need int32
    ``ids``, contiguous operands and F_B ∈ {32, 64, 128}."""
    if emit not in ("sums", "decode"):
        raise ValueError(f"emit must be 'sums' or 'decode', got {emit!r}")
    if kernel_route(deltas.device) == "torch":
        return compressed_chunked_spmv_ref(
            x, ids, block_first, deltas, valid_count, bits, edge_active,
            block_weights, n=n, emit=emit,
        )
    return _launch_chunked(x, ids, block_first, deltas, valid_count, bits, edge_active,
                           block_weights, n, emit)


compressed_chunked_spmv.launches = 0


def compressed_block_spmv(
    x: torch.Tensor,
    block_first: torch.Tensor,
    deltas: torch.Tensor,
    valid_count: torch.Tensor,
    bits: torch.Tensor | None,
    edge_active: torch.Tensor | None = None,
    block_weights: torch.Tensor | None = None,
    *,
    n: int,
    tile_blocks: int = DEFAULT_TILE_BLOCKS,
) -> torch.Tensor:
    """Per-block partial sums off the compressed stream, every block:
    ``out[b] = Σ_slot mask(b, slot) · w(b, slot) · x[decode(b)[slot]]``.

    The raw kernel entry of ``compressed_spmv_vertex``: no owner reduction,
    and blocks holding ESCAPE deltas decode wrong on purpose (the callers in
    ``ops.py`` patch them).  ``x`` is (n_pad,) → (NB,) or a (B, n_pad) batch
    → (NB, B), float32 or int32.  ``tile_blocks`` (1..32) is the number of
    warps per CTA on the card; each warp takes a tile of 32 consecutive
    blocks (4 for a batch), 16 lanes a block at F_B = 128 and 8 below.
    Same results as
    ``compressed_block_spmv_ref`` (exactly for int32 ``x``, up to float
    summation order for float32)."""
    tile_blocks = check_tile_blocks(tile_blocks)
    if kernel_route(deltas.device) == "torch":
        return compressed_block_spmv_ref(
            x, block_first, deltas, valid_count, bits, edge_active, block_weights, n=n
        )
    NB, FB, dev = _check_graph(block_first, deltas, valid_count, bits, edge_active,
                               block_weights)
    B, stride, out = sums_output(x, n, dev, NB)
    mode = _sums_mode(x, block_weights is not None)
    status = _entry("compressed_block_spmv_launch", _BLOCK_ARGTYPES)(
        block_first.data_ptr(), deltas.data_ptr(), valid_count.data_ptr(), data_ptr(bits),
        data_ptr(edge_active), data_ptr(block_weights), NB, FB, n, mode, tile_blocks,
        x.data_ptr(), B, stride, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "compressed_block_spmv")
    compressed_block_spmv.launches += 1
    return out


compressed_block_spmv.launches = 0


def _rows(name, t, B, n, dtype, dev):
    """Check a (n,) / (B, n) vertex operand; returns its row stride."""
    if tuple(t.shape[:-1]) != ((B,) if B else ()) or t.shape[-1] != n:
        raise ValueError(f"{name} must have shape {(B, n) if B else (n,)}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the graph on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride along vertices")
    return t.stride(0) if B else 0


def compressed_stream_round(
    x: torch.Tensor,
    frontier: torch.Tensor,
    block_src: torch.Tensor,
    block_first: torch.Tensor,
    deltas: torch.Tensor,
    valid_count: torch.Tensor,
    edge_active: torch.Tensor | None = None,
    block_weights: torch.Tensor | None = None,
    exc_row: torch.Tensor | None = None,
    exact_rows: torch.Tensor | None = None,
    *,
    n: int,
    map_kind: str,
    map_lanes: torch.Tensor | None = None,
):
    """One ``sparse_streamed`` round of min over int32, in one launch:
    ``(out, touched)``, (n,) each for a 1-D ``x``, (B, n) for a (B, n) batch.

    Every block whose owner a query's ``frontier`` holds is decoded (only
    those blocks' bytes are read); each masked-in slot min-s
    ``map(x[owner], w)`` into ``out[dst]`` and sets ``touched[dst]``.
    ``map_kind`` is a key of ``ROUND_MAPS``; ``map_lanes`` (bool (B,))
    picks the queries the map applies to.  A block with ``exc_row >= 0``
    (the graph's exception blocks) takes its targets from that row of
    ``exact_rows``.  On the card a warp takes a tile of 8 blocks and the
    min goes through atomics; ``x`` and ``frontier`` may have any row
    stride.  Exactly ``compressed_stream_round_ref``'s results."""
    if map_kind not in ROUND_MAPS:
        raise ValueError(f"no fused round for map {map_kind!r}; known: {sorted(ROUND_MAPS)}")
    if kernel_route(deltas.device) == "torch":
        return compressed_stream_round_ref(
            x, frontier, block_src, block_first, deltas, valid_count, edge_active,
            block_weights, exc_row, exact_rows, n=n, map_kind=map_kind, map_lanes=map_lanes,
        )
    NB, FB, dev = _check_graph(block_first, deltas, valid_count, None, edge_active,
                               block_weights)
    check_operand("block_src", block_src, (torch.int32,), (NB,), dev)
    if (exc_row is None) != (exact_rows is None):
        raise ValueError("exc_row and exact_rows come together")
    if exc_row is not None:
        check_operand("exc_row", exc_row, (torch.int32,), (NB,), dev)
        check_operand("exact_rows", exact_rows, (torch.int32,), (exact_rows.shape[0], FB),
                      dev, align=16)
    batched = x.dim() == 2
    B = x.shape[0] if batched else 1
    x_stride = _rows("x", x, B if batched else 0, n, torch.int32, dev)
    f_stride = _rows("frontier", frontier, B if batched else 0, n, torch.bool, dev)
    if map_lanes is not None:
        check_operand("map_lanes", map_lanes, (torch.bool,), (B,), dev, align=1)
    out = torch.full((n, B), INF_I32, dtype=torch.int32, device=dev)
    touched = torch.zeros((n, B), dtype=torch.bool, device=dev)
    if NB and B:
        status = _entry("compressed_stream_round_launch", _ROUND_ARGTYPES)(
            block_src.data_ptr(), block_first.data_ptr(), deltas.data_ptr(),
            valid_count.data_ptr(), data_ptr(edge_active), data_ptr(block_weights),
            data_ptr(exc_row), data_ptr(exact_rows), NB, FB, n, ROUND_MAPS[map_kind],
            frontier.data_ptr(), f_stride, x.data_ptr(), x_stride, data_ptr(map_lanes), B,
            out.data_ptr(), touched.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        check_launch(status, "compressed_stream_round")
        compressed_stream_round.launches += 1
    return (out.T, touched.T) if batched else (out[:, 0], touched[:, 0])


compressed_stream_round.launches = 0
