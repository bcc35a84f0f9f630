"""The frontier-sparse compressed-block kernel: wrapper and dispatch.

``compressed_chunked_spmv`` is the port of ``compressed_chunked_spmv_pallas``.
Given one chunk of the compacted live-block id list it decodes only those
blocks (``emit="decode"``: masked targets plus the aligned weight tile, the
chunk pool of EDGEMAPCHUNKED) or sums their masked weighted gather
(``emit="sums"``, single query or a (B, n) batch decoded once per block).

Dispatch follows the device of the graph tensors and nothing else: CUDA
tensors launch the hand-written kernel in ``csrc/compressed_chunked_spmv.cu``
(built for ``sm_90a`` on first use), CPU tensors run the plain PyTorch
version ``ref.compressed_chunked_spmv_ref``.  A CUDA call that the kernel
cannot take raises; nothing falls back.

Unlike the TPU wrapper, nothing is padded or pre-gathered: the kernel loads
row ``ids[i]`` directly and treats ``id >= NB`` as an all-sentinel row, so a
call reads only the live blocks' bytes and copies no graph array.

``compressed_chunked_spmv.launches`` counts the kernel launches (a plain
integer, bumped once per launch and nowhere else).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ...device import kernel_route
from ..build import check_launch, load_library
from .ref import compressed_chunked_spmv_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "compressed_chunked_spmv.cu"
BLOCK_SIZES = (32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _I, _P, _P, _P, _P, _P, _P,   # ids, C, first, deltas, valid_count, bits, active, w
    _I, _I, _I, _I,                   # NB, FB, n, mode
    _P, _I, ctypes.c_longlong,        # x, B, x row stride
    _P, _P, _P, _P,                   # dst_out, w_out, sums_out, stream
]
_MODE_DECODE, _MODE_SUMS_F32, _MODE_SUMS_I32, _MODE_SUMS_I32_W = 0, 1, 2, 3


def _entry():
    fn = load_library(SOURCE).compressed_chunked_spmv_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(name, t, dtypes, shape, device, align=4):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the graph on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(x, ids, block_first, deltas, valid_count, bits, edge_active,
            block_weights, n, emit):
    dev = deltas.device
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be (NB, FB), got {tuple(deltas.shape)}")
    NB, FB = deltas.shape
    if FB not in BLOCK_SIZES:
        raise ValueError(f"block size {FB} not supported by the kernel ({BLOCK_SIZES})")
    S = FB // 32  # slots per lane, and packed mask words per block
    _check("deltas", deltas, (torch.int16, torch.uint16), (NB, FB), dev, align=2 * S)
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D, got {tuple(ids.shape)}")
    C = ids.shape[0]
    _check("ids", ids, (torch.int32,), (C,), dev)
    _check("block_first", block_first, (torch.int32,), (NB,), dev)
    _check("valid_count", valid_count, (torch.int16, torch.uint16), (NB,), dev, align=2)
    for name, t in (("bits", bits), ("edge_active", edge_active)):
        if t is not None:
            _check(name, t, (torch.int32,), (NB, S), dev)
    if block_weights is not None:
        _check("block_weights", block_weights, (torch.float32,), (NB, FB), dev, align=4 * S)

    stream = torch.cuda.current_stream(dev).cuda_stream
    if emit == "decode":
        dst = torch.empty((C, FB), dtype=torch.int32, device=dev)
        w = torch.empty((C, FB), dtype=torch.float32, device=dev)
        mode, x_ptr, B, stride, sums, result = _MODE_DECODE, None, 1, 0, None, (dst, w)
    else:
        if x is None or x.dim() not in (1, 2):
            raise ValueError("emit='sums' needs x of shape (n_pad,) or (B, n_pad)")
        _check("x", x, (torch.float32, torch.int32), x.shape, dev)
        if x.shape[-1] < n:
            raise ValueError(f"x has {x.shape[-1]} columns, fewer than n={n}")
        batched = x.dim() == 2
        B = x.shape[0] if batched else 1
        stride = x.shape[-1]
        if x.dtype == torch.float32:
            mode = _MODE_SUMS_F32
        else:
            mode = _MODE_SUMS_I32_W if block_weights is not None else _MODE_SUMS_I32
        sums = torch.empty((C, B) if batched else (C,), dtype=x.dtype, device=dev)
        x_ptr, dst, w, result = x.data_ptr(), None, None, sums
    if C == 0:
        return result
    status = _entry()(
        ids.data_ptr(), C, block_first.data_ptr(), deltas.data_ptr(),
        valid_count.data_ptr(), _ptr(bits), _ptr(edge_active), _ptr(block_weights),
        NB, FB, n, mode, x_ptr, B, stride, _ptr(dst), _ptr(w), _ptr(sums), stream,
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
    return _launch(x, ids, block_first, deltas, valid_count, bits, edge_active,
                   block_weights, n, emit)


compressed_chunked_spmv.launches = 0
