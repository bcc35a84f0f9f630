"""The uncompressed-block SpMV kernel: wrapper and dispatch.

``edge_block_spmv`` is the port of ``edge_block_spmv_pallas``: per-block
partial sums of the masked weighted gather over the blocked CSR's int32
targets and float32 weights, (NB,) or (NB, B) for a (B, n_pad) batch whose
B columns share each block's single read.  Given the graph's owner arrays
(``owners=(block_src, block_offsets, degrees)``) the kernel derives each
block's real-slot count and reads only those slots; without them it reads
whole rows.

Dispatch follows the device of the graph tensors and nothing else: CUDA
tensors launch the hand-written kernel in ``csrc/edge_block_spmv.cu``
(built for ``sm_90a`` on first use), CPU tensors run the plain PyTorch
version ``ref.edge_block_spmv_ref``.  A CUDA call that the kernel cannot
take raises; nothing falls back.  Nothing is padded: the kernel's last CTA
bounds-checks its warps.

``edge_block_spmv.launches`` counts the kernel launches (a plain integer,
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
from .ref import edge_block_spmv_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "edge_block_spmv.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P,                   # block_dst, block_w, bits, active
    _P, _P, _P,                       # block_src, block_offsets, degrees (NULL: whole rows)
    _I, _I, _I, _I, _I,               # NB, FB, n, mode, warps per CTA
    _P, _I, ctypes.c_longlong,        # x, B, x row stride
    _P, _P,                           # out, stream
]
_MODE_F32, _MODE_I32 = 1, 2


def _entry():
    fn = load_library(SOURCE).edge_block_spmv_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def edge_block_spmv(
    x: torch.Tensor,
    block_dst: torch.Tensor,
    block_w: torch.Tensor,
    bits: torch.Tensor | None,
    edge_active: torch.Tensor | None = None,
    *,
    n: int,
    tile_blocks: int = DEFAULT_TILE_BLOCKS,
    owners: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Per-block partial sums ``out[b] = Σ_slot mask · w · x[dst]`` off the
    uncompressed stream, ``mask = dst < n ∧ bits ∧ edge_active``.

    The raw kernel entry of ``spmv_vertex`` (no owner reduction).  ``x`` is
    (n_pad,) → (NB,) or a (B, n_pad) batch → (NB, B), float32 or int32;
    ``tile_blocks`` (1..32) is the number of warps per CTA on the card.
    ``owners`` is the graph's ``(block_src, block_offsets, degrees)``: the
    kernel then reads only each block's real slots (``ref.real_slot_counts``)
    instead of whole rows.  The result does not depend on it.  Same results
    as ``edge_block_spmv_ref`` (exactly for int32 ``x`` of small values, up
    to float summation order otherwise)."""
    tile_blocks = check_tile_blocks(tile_blocks)
    if kernel_route(block_dst.device) == "torch":
        return edge_block_spmv_ref(x, block_dst, block_w, bits, edge_active, n=n,
                                   owners=owners)
    dev = block_dst.device
    if block_dst.dim() != 2:
        raise ValueError(f"block_dst must be (NB, FB), got {tuple(block_dst.shape)}")
    NB, FB = block_dst.shape
    if FB not in BLOCK_SIZES:
        raise ValueError(f"block size {FB} not supported by the kernel ({BLOCK_SIZES})")
    S = FB // 32
    check_operand("block_dst", block_dst, (torch.int32,), (NB, FB), dev, align=16)
    check_operand("block_w", block_w, (torch.float32,), (NB, FB), dev, align=16)
    for name, t in (("bits", bits), ("edge_active", edge_active)):
        if t is not None:
            check_operand(name, t, (torch.int32,), (NB, S), dev)
    if owners is not None:
        block_src, block_offsets, degrees = owners
        check_operand("block_src", block_src, (torch.int32,), (NB,), dev)
        check_operand("block_offsets", block_offsets, (torch.int32,), (n + 1,), dev)
        check_operand("degrees", degrees, (torch.int32,), (n,), dev)
    B, stride, out = sums_output(x, n, dev, NB)
    mode = _MODE_F32 if x.dtype == torch.float32 else _MODE_I32
    status = _entry()(
        block_dst.data_ptr(), block_w.data_ptr(), data_ptr(bits), data_ptr(edge_active),
        *(data_ptr(t) for t in (owners or (None, None, None))),
        NB, FB, n, mode, tile_blocks, x.data_ptr(), B, stride, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "edge_block_spmv")
    edge_block_spmv.launches += 1
    return out


edge_block_spmv.launches = 0
