"""Single-token decode attention (flash-decoding): wrapper and dispatch.

``decode_attention`` is the port of ``decode_attention_pallas``: one query
token per sequence against its KV cache, the first ``pos[b]`` rows, with a
float32 online softmax.  q head ``h`` reads KV head ``h // (Hq // Hkv)``,
the head that the JAX package's ``jnp.repeat`` gives it; the kernel groups
the q heads over the KV heads, so K/V are read once per KV head and never
repeated.

Dispatch follows the device of the tensors and nothing else: CUDA tensors
launch the hand-written kernel in ``csrc/decode_attention.cu`` (built for
``sm_90a`` on first use), CPU tensors run the plain PyTorch version
``ref.decode_attention_ref``.  A CUDA call that the kernel cannot take
raises; nothing falls back.

On the card the cache is cut into ``splits`` ranges of rows, so that
``B · Hkv · head chunks · splits`` CTAs fill the SMs (``split_count``, from
the CTAs an SM holds at once, which the card's occupancy calculator reads
off the kernel the call takes).  bfloat16 at D >= 16 takes the tensor-core
kernel: one lane of a producer warp keeps an 8-stage ring of 32-row K/V
tiles in flight for four consumer warps, each tile TMA boxes of 4-D tensor
maps over (D, Hkv, S, B) that the C entry point builds at every launch
(129 KB of shared memory at D = 128, one CTA an SM: 8 splits at
qwen2-1.5b's 32 × 32k shape on an H100); float32 and D = 8 take the
CUDA-core kernel (3 CTAs an SM there).  Each CTA writes a partial
``(m, l, acc)`` to float32 scratch that this wrapper allocates,
``B · Hq · splits · (D + 2)`` floats, and a second kernel combines the
splits into the output.

With ``return_lse=True`` the combine also writes each row's log-sum-exp
and leaves the output in float32, so that the partials of a cache sharded
along its rows merge across ranks with one rounding
(``repro_torch.distributed.serving.merge_attention``).

``decode_attention.launches`` counts the launches of the attention
kernel (a plain integer, bumped once per launch and nowhere else).
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from ...device import kernel_route
from ..build import check_launch, check_operand, load_library
from .ref import decode_attention_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)   # D the kernel takes
HEAD_CHUNK = 8                     # q heads of one group a CTA holds at most
WAVES = 4                          # waves of resident CTAs a split count aims at
MIN_SPLIT_ROWS = 128               # fewer rows than this per split is not worth a CTA
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P,        # q, k, v, pos
    _I, _I, _I, _I, _I,    # B, S, Hq, Hkv, D
    _I, _I, _I,            # dtype code, splits, rows per split
    ctypes.c_float,        # 1/sqrt(D)
    _P, _P, _P,            # partial m, partial l, partial acc
    _P, _P, _P,            # out, lse (null: none), stream
]


def _entry():
    fn = load_library(SOURCE).decode_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _resident_ctas(index: int, dtype: torch.dtype, D: int, group: int) -> int:
    """Attention CTAs the card holds at once (per SM, times its SMs) for
    this dtype, head dim and q heads per KV head."""
    fn = load_library(SOURCE).decode_attention_occupancy
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    per_sm = _I(0)
    check_launch(fn(_DTYPES[dtype], D, group, ctypes.byref(per_sm)), "decode_attention")
    return per_sm.value * torch.cuda.get_device_properties(index).multi_processor_count


def split_count(B: int, Hq: int, Hkv: int, S: int, resident: int) -> int:
    """How many row ranges the cache of each (sequence, KV head) is cut into.

    About ``WAVES`` waves of the ``resident`` CTAs the card holds at once,
    the last nearly full, so that the CTAs fill the SMs to the end; but no
    range shorter than ``MIN_SPLIT_ROWS`` rows (a CTA takes 32 rows a warp
    at a time: a ring stage on the tensor-core kernel), and at least one.  It reads the cache length
    ``S``, not ``pos``, so it needs no read of the device; ranges past a
    sequence's ``pos`` exit at once."""
    per_split = B * Hkv * -(-(Hq // Hkv) // HEAD_CHUNK)
    return max(1, min(WAVES * resident // per_split, S // MIN_SPLIT_ROWS))


def split_rows(q: torch.Tensor, k: torch.Tensor) -> tuple[int, int]:
    """``(splits, rows per split)`` of a launch on CUDA tensors ``q``, ``k``."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    resident = _resident_ctas(q.device.index or 0, q.dtype, D, Hq // Hkv)
    rows = -(-S // split_count(B, Hq, Hkv, S, resident))
    return -(-S // rows), rows


def kernel_config(q: torch.Tensor, k: torch.Tensor) -> dict:
    """What a launch on CUDA tensors ``q``, ``k`` runs: the body, its copy
    mechanism, ring stages and rows a stage (the tensor-core body), warps
    and CTAs an SM, and ``(splits, rows per split)``."""
    B, Hq, D = q.shape
    tensor_cores = q.dtype == torch.bfloat16 and D >= 16
    per_sm = _resident_ctas(q.device.index or 0, q.dtype, D, Hq // k.shape[2]) // (
        torch.cuda.get_device_properties(q.device.index or 0).multi_processor_count)
    out = {"body": "tensor cores (mma.sync m16n8k16, bf16)" if tensor_cores
           else "CUDA cores (float32 FMA)", "ctas_per_sm": per_sm, "split": split_rows(q, k)}
    if tensor_cores:
        fn = load_library(SOURCE).decode_attention_ring
        fn.argtypes = [ctypes.POINTER(_I)] * 4
        fn.restype = None
        vals = [_I(0) for _ in range(4)]
        fn(*(ctypes.byref(x) for x in vals))
        stages, rows, consumers, heads = (x.value for x in vals)
        out.update(copy="cp.async.bulk.tensor (TMA): boxes of a 4-D tensor map, mbarrier ring",
                   stages=stages, rows_per_stage=rows, warps=consumers + 1,
                   consumer_warps=consumers, heads_per_cta=heads)
    else:
        out.update(copy="cp.async 16 B, one tile in flight a warp", warps=4)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, return_lse: bool = False):
    """q (B, Hq, D); k, v (B, S, Hkv, D), Hkv dividing Hq; pos (B,) int32
    with ``1 <= pos <= S`` → (B, Hq, D) in ``q.dtype``.  On the card: float32
    or bfloat16 (q, k and v of one dtype), D in ``HEAD_DIMS``, contiguous
    operands.  ``decode_attention_ref``'s function, with the sums in another
    order.

    ``return_lse=True`` (a cache sharded along its rows, one slice a rank)
    gives ``(out, lse)``: ``out`` (B, Hq, D) float32, unrounded, and ``lse``
    (B, Hq) float32, the natural-log log-sum-exp of the scaled scores over
    the first ``pos[b]`` rows; the domain is ``0 <= pos <= S``, and a
    sequence at 0 gives ``out`` 0 and ``lse`` -inf, the identity of the
    merge across slices."""
    if kernel_route(q.device) == "torch":
        return decode_attention_ref(q, k, v, pos, return_lse=return_lse)
    dev = q.device
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and k (B, S, H, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel ({HEAD_DIMS})")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} q heads do not group over {Hkv} kv heads")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    check_operand("q", q, (q.dtype,), (B, Hq, D), dev)
    check_operand("k", k, (q.dtype,), (B, S, Hkv, D), dev, align=16)
    check_operand("v", v, (q.dtype,), (B, S, Hkv, D), dev, align=16)
    check_operand("pos", pos, (torch.int32,), (B,), dev)
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.full((B, Hq), -math.inf, dtype=torch.float32, device=dev) if return_lse else None
    if B == 0 or S == 0:
        return (out.zero_(), lse) if return_lse else out.zero_()
    splits, rows = split_rows(q, k)
    part_m = torch.empty((B, Hq, splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hq, splits, D), dtype=torch.float32, device=dev)
    status = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        B, S, Hq, Hkv, D, _DTYPES[q.dtype], splits, rows, 1.0 / math.sqrt(D),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(status, "decode_attention")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
