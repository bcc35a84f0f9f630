"""The graphFilter pack kernel (edgeMapPack, §4.2.2): wrapper and dispatch.

``filter_pack_words`` is the port of ``filter_pack_pallas``: pack a bool
keep predicate into little-endian words, AND them into the filter words of
the blocks whose owner is in the subset, and count each block's live bits.

Dispatch follows the device of the tensors and nothing else: CUDA tensors
launch the hand-written kernel in ``csrc/filter_pack.cu`` (built for
``sm_90a`` on first use), CPU tensors run the plain PyTorch version
``ref.filter_pack_ref``.  A CUDA call that the kernel cannot take raises;
nothing falls back.  Nothing is padded: the kernel bounds-checks its
rows.  The kernel loads ``keep`` 16 bytes at a time, so it must be
16-byte aligned (a fresh tensor is).

``filter_pack_words.launches`` counts the kernel launches (a plain
integer, bumped once per launch and nowhere else).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ...device import kernel_route
from ...tuning.defaults import DEFAULT_TILE_BLOCKS
from ..build import BLOCK_SIZES, check_launch, check_operand, load_library
from .ref import filter_pack_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "filter_pack.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P,        # bits, keep, subset
    _I, _I, _I,        # NB, FB, warps per CTA
    _P, _P, _P,        # new bits, count, stream
]


def _entry():
    fn = load_library(SOURCE).filter_pack_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def filter_pack_words(
    bits: torch.Tensor,
    keep: torch.Tensor,
    subset: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``bits`` int32 (NB, W) filter words, ``keep`` bool (NB, 32·W) slot
    predicate, ``subset`` bool (NB,) → ``(new_bits int32 (NB, W), count
    int32 (NB,))``: ``new_bits = subset ? bits & pack(keep) : bits`` and
    ``count`` its popcount per row.  On the card a lane packs 16 keep
    bytes, a warp takes 4 groups of 512 / F_B rows, and a CTA holds
    ``DEFAULT_TILE_BLOCKS`` warps.  Exactly ``filter_pack_ref``'s
    results."""
    if kernel_route(bits.device) == "torch":
        return filter_pack_ref(bits, keep, subset)
    dev = bits.device
    if bits.dim() != 2:
        raise ValueError(f"bits must be (NB, W), got {tuple(bits.shape)}")
    NB, W = bits.shape
    FB = 32 * W
    if FB not in BLOCK_SIZES:
        raise ValueError(f"block size {FB} not supported by the kernel ({BLOCK_SIZES})")
    check_operand("bits", bits, (torch.int32,), (NB, W), dev)
    check_operand("keep", keep, (torch.bool,), (NB, FB), dev, align=16)
    check_operand("subset", subset, (torch.bool,), (NB,), dev, align=1)
    new_bits = torch.empty_like(bits)
    count = torch.empty(NB, dtype=torch.int32, device=dev)
    if NB == 0:
        return new_bits, count
    status = _entry()(
        bits.data_ptr(), keep.data_ptr(), subset.data_ptr(), NB, FB, DEFAULT_TILE_BLOCKS,
        new_bits.data_ptr(), count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "filter_pack")
    filter_pack_words.launches += 1
    return new_bits, count


filter_pack_words.launches = 0
