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

The sums are differentiable with respect to the table: where the table
(or the weights) asks for a gradient, ``embedding_bag_sums`` goes through
an ``autograd.Function`` whose backward is ``embedding_bag_backward``, the
backward kernel (kernel 5', same source) on a CUDA tensor and
``ref.embedding_bag_backward_ref`` on a CPU one.  It takes a float32 table
only (a bfloat16 table raises ``TypeError`` in the backward) and gives no
gradient for the weights (``NotImplementedError``), as the Pallas kernel
has none.  ``embedding_bag_backward.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ...device import kernel_route
from ..build import check_launch, check_operand, load_library
from .ref import BACKWARD_CHUNK, backward_plan, embedding_bag_backward_ref, embedding_bag_ref

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


_BACKWARD_ARGTYPES = [
    _P, _P, _P,                # grad_out, order, weights (NULL: every weight 1)
    _P, _P, _P, _I,            # row_start, chunk_base, partials, max_chunks
    _I, _I, _I, _I,            # V, D, L, chunk
    _P, _P,                    # out, stream
]


def _entry(name="embedding_bag_launch", argtypes=_ARGTYPES):
    fn = getattr(load_library(SOURCE), name)
    fn.argtypes = argtypes
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
    contiguous operands.  Exactly ``embedding_bag_ref``'s arithmetic.
    Differentiable with respect to a float32 table (see the module note)."""
    if weights is not None:
        weights = weights.to(table.dtype)
    if torch.is_grad_enabled() and (table.requires_grad
                                    or (weights is not None and weights.requires_grad)):
        return _BagSums.apply(table, indices, weights)
    return _bag_sums(table, indices, weights)


def _bag_sums(table, indices, weights):
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


class _BagSums(torch.autograd.Function):
    """The bag sums with the backward kernel as their gradient."""

    @staticmethod
    def forward(ctx, table, indices, weights):
        ctx.save_for_backward(indices, weights)
        ctx.V, ctx.dtype = table.shape[0], table.dtype
        return _bag_sums(table, indices, weights)

    @staticmethod
    def backward(ctx, grad_out):
        indices, weights = ctx.saved_tensors
        if ctx.needs_input_grad[2]:
            raise NotImplementedError("the EmbeddingBag kernel gives no gradient with respect "
                                      "to its weights (nor does the Pallas kernel)")
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if ctx.dtype != torch.float32:
            raise TypeError(f"the EmbeddingBag backward takes a float32 table, not {ctx.dtype}")
        return embedding_bag_backward(grad_out.contiguous(), indices, ctx.V, weights), None, None


def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor, V: int,
                           weights: torch.Tensor | None = None) -> torch.Tensor:
    """The gradient of ``embedding_bag_sums(table, indices, weights)`` with
    respect to a (V, D) float32 table, given ``grad_out`` (B, D) float32:
    (V, D) float32, each row the float32 sum of ``w * grad_out[b]`` over the
    slots holding its id, untouched rows exact zeros.  On the card the
    backward kernel (its preparation, a stable sort of the ids, in torch
    ops), bit for bit ``embedding_bag_backward_ref``; on the CPU that plain
    version.  Deterministic: no float atomics."""
    if kernel_route(grad_out.device) == "torch":
        return embedding_bag_backward_ref(grad_out, indices, V, weights)
    dev = grad_out.device
    if grad_out.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"grad_out must be (B, D) and indices (B, L), got "
                         f"{tuple(grad_out.shape)}, {tuple(indices.shape)}")
    B, D = grad_out.shape
    L = indices.shape[1]
    check_operand("grad_out", grad_out, (torch.float32,), (B, D), dev)
    check_operand("indices", indices, (torch.int32,), (B, L), dev)
    if weights is not None:
        check_operand("weights", weights, (torch.float32,), (B, L), dev)
    out = torch.empty((V, D), dtype=torch.float32, device=dev)
    if V == 0 or D == 0:
        return out
    if B * L == 0:
        return out.zero_()
    order, row_start, chunk_base = backward_plan(indices, V)
    max_chunks = 2 * B * L // BACKWARD_CHUNK + 1  # a row of n > chunk slots has < 2n/chunk
    partials = torch.empty((max_chunks, D), dtype=torch.float32, device=dev)
    status = _entry("embedding_bag_backward_launch", _BACKWARD_ARGTYPES)(
        grad_out.data_ptr(), order.data_ptr(), None if weights is None else weights.data_ptr(),
        row_start.data_ptr(), chunk_base.data_ptr(), partials.data_ptr(), max_chunks,
        V, D, L, BACKWARD_CHUNK, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "embedding_bag_backward")
    embedding_bag_backward.launches += 1
    return out


embedding_bag_backward.launches = 0
