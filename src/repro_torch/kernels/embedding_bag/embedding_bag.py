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
an ``autograd.Function`` whose backward is ``embedding_bag_backward``: on a
CUDA tensor its preparation (``embedding_bag_plan``, the port's own stable
radix sort of the slots by id, ``csrc/bag_plan.cu``) and then the backward
kernel (kernel 5', same source as the forward); on a CPU one
``ref.embedding_bag_backward_ref``.  It takes a float32 table only (a
bfloat16 table raises ``TypeError`` in the backward) and gives no gradient
for the weights (``NotImplementedError``), as the Pallas kernel has none.
``embedding_bag_plan.launches`` and ``embedding_bag_backward.launches``
count the two calls, one each a backward.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ...device import kernel_route
from ..build import check_launch, check_operand, load_library
from .ref import (
    BACKWARD_CHUNK,
    backward_plan,
    backward_sums_ref,
    embedding_bag_backward_ref,
    embedding_bag_ref,
)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
PLAN_SOURCE = SOURCE.with_name("bag_plan.cu")  # the backward's preparation
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
    _P, _P, _P, _P, _I,        # row_start, chunk_base, partials, chunk_row, max_chunks
    _I, _I, _I,                # V, D, L
    _P, _P,                    # out, stream
]
_PLAN_ARGTYPES = [
    _P, _I, _I,                # ids, N, V
    _P, _P, _P,                # order, row_start, chunk_base
    _P, ctypes.c_longlong, _P,  # scratch, its int32 words, stream
]


def _entry(name="embedding_bag_launch", argtypes=_ARGTYPES, source=SOURCE):
    fn = getattr(load_library(source), name)
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


def embedding_bag_plan(indices: torch.Tensor, V: int):
    """The preparation of the backward: ``backward_plan``'s ``(order,
    row_start, chunk_base)`` for ``indices`` (int32, any shape) and a table
    of ``V`` rows, long rows in chunks of ``BACKWARD_CHUNK`` slots.  On the
    card the port's own sort (``csrc/bag_plan.cu``, a stable radix sort over
    the bits ``V - 1`` needs, then a boundary pass and a scan): ``row_start`` and ``chunk_base`` bit for bit ``backward_plan``'s
    and ``order[:row_start[V]]`` too; the padding slots, which
    ``backward_plan`` places last, are dropped, so the rest of ``order`` is
    left unwritten.  On the CPU ``backward_plan`` itself.  ``B * L >= 2**31``
    raises ``ValueError``.  ``embedding_bag_plan.launches`` counts the card's
    calls (one a call; each launches the sort's kernels once)."""
    if kernel_route(indices.device) == "torch":
        return backward_plan(indices, V)
    N = indices.numel()
    if N >= 2 ** 31:
        raise ValueError(f"the EmbeddingBag backward numbers its slots in int32: "
                         f"{N} slots is too many")
    if V < 1:
        raise ValueError(f"the card's preparation needs a table of at least one row, got V={V}")
    dev = indices.device
    check_operand("indices", indices, (torch.int32,), indices.shape, dev)
    lib = load_library(PLAN_SOURCE)
    words_of = lib.embedding_bag_plan_words
    words_of.argtypes, words_of.restype = [_I, _I], ctypes.c_longlong
    words = words_of(N, V)
    order = torch.empty(N, dtype=torch.int32, device=dev)
    row_start = torch.empty(V + 1, dtype=torch.int32, device=dev)
    chunk_base = torch.empty(V + 1, dtype=torch.int32, device=dev)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    status = _entry("embedding_bag_plan_launch", _PLAN_ARGTYPES, PLAN_SOURCE)(
        indices.data_ptr(), N, V, order.data_ptr(), row_start.data_ptr(),
        chunk_base.data_ptr(), scratch.data_ptr(), words,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "embedding_bag_plan")
    embedding_bag_plan.launches += 1
    return order, row_start, chunk_base


embedding_bag_plan.launches = 0


def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor, V: int,
                           weights: torch.Tensor | None = None) -> torch.Tensor:
    """The gradient of ``embedding_bag_sums(table, indices, weights)`` with
    respect to a (V, D) float32 table, given ``grad_out`` (B, D) float32:
    (V, D) float32, each row the float32 sum of ``w * grad_out[b]`` over the
    slots holding its id, untouched rows exact zeros.  On the card the
    preparation (``embedding_bag_plan``) and then the backward kernel
    (``_backward_sums``), bit for bit ``embedding_bag_backward_ref``; on the
    CPU that plain version.  Deterministic: no float atomics."""
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
    if V == 0 or D == 0:
        return torch.empty((V, D), dtype=torch.float32, device=dev)
    if B * L == 0:
        return torch.zeros((V, D), dtype=torch.float32, device=dev)
    order, row_start, chunk_base = embedding_bag_plan(indices, V)
    return _backward_sums(grad_out, order, row_start, chunk_base, L, weights)


def _backward_sums(grad_out, order, row_start, chunk_base, L: int, weights=None):
    """The backward kernel alone, the sums given the plan of a (B, L) lookup
    that ``embedding_bag_plan`` (or ``backward_plan`` with its default chunk)
    made: (V, D) float32 from ``grad_out`` (B, D).  Operands that do not fit
    one another raise.  On the card the kernel
    (``embedding_bag_backward.launches`` counts its calls), on the CPU
    ``ref.backward_sums_ref``."""
    if grad_out.dim() != 2 or row_start.dim() != 1 or row_start.numel() < 1:
        raise ValueError(f"grad_out must be (B, D) and row_start (V + 1,), got "
                         f"{tuple(grad_out.shape)}, {tuple(row_start.shape)}")
    B, D = grad_out.shape
    V = row_start.numel() - 1
    dev = grad_out.device
    on_card = kernel_route(dev) != "torch"
    for name, t, dtype, shape in (("grad_out", grad_out, torch.float32, (B, D)),
                                  ("order", order, torch.int32, (B * L,)),
                                  ("row_start", row_start, torch.int32, (V + 1,)),
                                  ("chunk_base", chunk_base, torch.int32, (V + 1,)),
                                  ("weights", weights, torch.float32, (B, L))):
        if t is None:
            continue
        if on_card:
            check_operand(name, t, (dtype,), shape, dev)
        elif t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got {t.dtype} "
                             f"of shape {tuple(t.shape)}")
    if not on_card:
        return backward_sums_ref(grad_out, order, row_start, L, weights)
    out = torch.empty((V, D), dtype=torch.float32, device=dev)
    max_chunks = 2 * B * L // BACKWARD_CHUNK + 1  # a row of n > chunk slots has < 2n/chunk
    partials = torch.empty((max_chunks, D), dtype=torch.float32, device=dev)
    chunk_row = torch.empty(max_chunks, dtype=torch.int32, device=dev)
    status = _entry("embedding_bag_backward_launch", _BACKWARD_ARGTYPES)(
        grad_out.data_ptr(), order.data_ptr(), None if weights is None else weights.data_ptr(),
        row_start.data_ptr(), chunk_base.data_ptr(), partials.data_ptr(), chunk_row.data_ptr(),
        max_chunks, V, D, L, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "embedding_bag_backward")
    embedding_bag_backward.launches += 1
    return out


embedding_bag_backward.launches = 0
