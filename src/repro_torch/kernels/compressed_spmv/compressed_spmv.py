"""The compressed-block kernels: wrappers and dispatch.

Two kernels share one CUDA source (``csrc/compressed_spmv.cu``):

* ``compressed_chunked_spmv`` is the port of ``compressed_chunked_spmv_pallas``.
  Given one chunk of the compacted live-block id list it decodes only those
  blocks (``emit="decode"``: masked targets plus the aligned weight tile, the
  chunk pool of EDGEMAPCHUNKED) or sums their masked weighted gather
  (``emit="sums"``, single query or a (B, n) batch decoded once per block).
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
from .ref import compressed_block_spmv_ref, compressed_chunked_spmv_ref

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
_MODE_DECODE, _MODE_SUMS_F32, _MODE_SUMS_I32, _MODE_SUMS_I32_W = 0, 1, 2, 3


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
