"""The EmbeddingBag kernel (gather + weighted bag sum): wrapper and dispatch.

``embedding_bag_sums`` is the port of ``embedding_bag_pallas``: the
weighted sum of the table rows of each fixed-width bag of ids, negative
ids (and ids ``>= V``) being padding.

Dispatch follows the device of the tensors and nothing else: CUDA tensors
launch the hand-written kernel in ``csrc/embedding_bag.cu`` (built for
``sm_90a`` on first use), CPU tensors run the plain PyTorch version
``ref.embedding_bag_ref``.  A CUDA call that the kernel cannot take raises;
nothing falls back.  Nothing is padded or copied: the kernel's last CTA
bounds-checks its warps.  Bags of one (``L == 1``, every ``take_rows``
call) take the kernel's own path for them, chosen from the shape: a warp
streams 32 bags' rows at once.

``embedding_bag_sums.launches`` counts the kernel launches (a plain
integer, bumped once per launch and nowhere else).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ...device import kernel_route
from ..build import check_launch, check_operand, load_library
from .ref import embedding_bag_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
VECTOR_BYTES = (16, 8, 4, 2)  # the row loads the kernel has, widest first
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P,                # table, ids, weights (NULL: every weight 1)
    _I, _I, _I, _I,            # V, D, B, L
    _I, _I,                    # dtype code, vector bytes
    _P, _P,                    # out, stream
]


def _entry():
    fn = load_library(SOURCE).embedding_bag_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def vector_bytes(row_bytes: int, elt: int, *addresses: int) -> int:
    """The widest row load that divides ``row_bytes`` and every address,
    but no narrower than one element of ``elt`` bytes: SASRec's float32
    rows of 200 B take 8, its bfloat16 rows of 100 B take 4."""
    for vb in VECTOR_BYTES:
        if vb >= elt and row_bytes % vb == 0 and all(a % vb == 0 for a in addresses):
            return vb
    raise ValueError(f"rows of {row_bytes} B at {addresses} are not {elt}-byte aligned")


def embedding_bag_sums(table: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """``table`` (V, D), ``indices`` (B, L) int32, ``weights`` (B, L) or None
    (every weight 1) → (B, D) bag sums in ``table.dtype``.  The weights are
    rounded to the table's dtype first, as the JAX kernel does; the sums are
    float32, rounded once.  On the card: a float32 or bfloat16 table,
    contiguous operands.  Exactly ``embedding_bag_ref``'s arithmetic."""
    if kernel_route(table.device) == "torch":
        return embedding_bag_ref(table, indices, weights)
    dev = table.device
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"table must be (V, D) and indices (B, L), got "
                         f"{tuple(table.shape)}, {tuple(indices.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    V, D = table.shape
    B, L = indices.shape
    check_operand("table", table, (table.dtype,), (V, D), dev, align=table.element_size())
    check_operand("indices", indices, (torch.int32,), (B, L), dev)
    if weights is not None:
        weights = weights.to(table.dtype)
        check_operand("weights", weights, (table.dtype,), (B, L), dev,
                      align=table.element_size())
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    if B == 0 or D == 0:
        return out
    vb = vector_bytes(D * table.element_size(), table.element_size(), table.data_ptr(),
                      out.data_ptr())
    status = _entry()(
        table.data_ptr(), indices.data_ptr(), None if weights is None else weights.data_ptr(),
        V, D, B, L, _DTYPES[table.dtype], vb,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "embedding_bag")
    embedding_bag_sums.launches += 1
    return out


embedding_bag_sums.launches = 0
