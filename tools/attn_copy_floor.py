#!/usr/bin/env python3
"""The copy floor of kernel 6 (decode attention) on one NVIDIA card.

    python3 tools/attn_copy_floor.py

Times, at qwen2-1.5b's long-context shape (B=32, S=pos=32,768, 12 q heads
over 2 KV heads, D=128, bfloat16), three kernels in one process:

* ``cp_async_floor``: the CUDA-core kernel's copy pipeline with its math
  taken out.  Each of 4 warps stages 32-row K and V tiles with 16-byte
  ``cp.async`` copies and waits on them exactly as ``attend_kernel`` does
  (same grid of 24 splits, same 73,728 B of shared memory, so 3 CTAs an
  SM); no score, softmax or product is computed.
* ``ring_floor``: a TMA ring of one ``cp.async.bulk`` per K row and per V
  row (no tensor map) with no math: a producer warp fills 4 stages of 32
  rows, 256-byte rows landing 272 bytes apart; two consumer warps wait on
  each stage and release it.  Timed at its own 3 CTAs an SM and, with more
  shared memory requested, at 2 and at 1: the design the tensor-core
  kernel tried first, before its tensor map.
* ``decode_attention`` itself, as the port calls it.

A floor near the kernel's time says the copies cost and the math hides
behind them; a floor well under it says the math or the merge costs.  The
copy-only kernels are measurement tools, never called by the port.  Needs
a CUDA device and ``nvcc``; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (32, 32768, 12, 2, 128)  # B, S, Hq, Hkv, D
HBM_BYTES_PER_S = 3.35e12

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int D = 128, HT = 6, kWarps = 4, kTile = 32;
constexpr int kRowBytes = D * 2, kKStride = kRowBytes + 16;
constexpr int kOldBytes = HT * D * 4 + kWarps * (kTile * (kKStride + kRowBytes) + HT * kTile * 4);
constexpr int kConsumers = 2, kStages = 4, kStride = kRowBytes + 16;
constexpr int kTileBytes = kTile * kStride, kStageBytes = 2 * kTileBytes;
constexpr int kRingBytes = 2 * kStages * 8 + kStages * kStageBytes;

__device__ __forceinline__ uint32_t sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* s, const void* g, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa(s)), "l"(g),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

template <int kDst>
__device__ __forceinline__ void stage(unsigned char* dst, const unsigned char* src, size_t stride,
                                      int t, int hi, int lane) {
  constexpr int kChunks = kRowBytes / 16;
#pragma unroll
  for (int i = lane; i < kTile * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = t + r < hi;
    cp16(dst + r * kDst + c * 16, src + (ok ? static_cast<size_t>(t + r) * stride + c * 16 : 0), ok);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
cp_async_floor(const void* k, const void* v, const int* pos, int S, int Hkv, int rows, float* out) {
  const int g = blockIdx.y, b = blockIdx.z, s = blockIdx.x;
  const int len = min(max(pos[b], 0), S);
  const int lo = s * rows, hi = min(lo + rows, len);
  if (lo >= hi) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* k_s = smem + HT * D * 4 + warp * (kTile * (kKStride + kRowBytes) + HT * kTile * 4);
  unsigned char* v_s = k_s + kTile * kKStride;
  const size_t stride = static_cast<size_t>(Hkv) * kRowBytes;
  const size_t head = (static_cast<size_t>(b) * S * Hkv + g) * kRowBytes;
  const unsigned char* kg = static_cast<const unsigned char*>(k) + head;
  const unsigned char* vg = static_cast<const unsigned char*>(v) + head;
  int t = lo + warp * kTile;
  if (t < hi) stage<kKStride>(k_s, kg, stride, t, hi, lane);
  commit();
  if (t < hi) stage<kRowBytes>(v_s, vg, stride, t, hi, lane);
  commit();
  for (; t < hi; t += kWarps * kTile) {
    const int next = t + kWarps * kTile;
    wait<1>();
    __syncwarp();
    __syncwarp();
    if (next < hi) stage<kKStride>(k_s, kg, stride, next, hi, lane);
    commit();
    wait<1>();
    __syncwarp();
    __syncwarp();
    if (next < hi) stage<kRowBytes>(v_s, vg, stride, next, hi, lane);
    commit();
  }
  wait<0>();
  __syncwarp();
  if (lane == 0) out[(static_cast<size_t>(b) * gridDim.y + g) * gridDim.x + s] = k_s[0] + v_s[0];
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(sa(bar)), "r"(parity) : "memory");
  } while (!done);
}

__global__ void __launch_bounds__((kConsumers + 1) * 32)
ring_floor(const void* k, const void* v, const int* pos, int S, int Hkv, int rows, float* out) {
  const int g = blockIdx.y, b = blockIdx.z, s = blockIdx.x;
  const int len = min(max(pos[b], 0), S);
  const int lo = s * rows, hi = min(lo + rows, len);
  if (lo >= hi) return;
  const int ntiles = (hi - lo + kTile - 1) / kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + 2 * kStages * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(full + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumers) {
    const size_t stride = static_cast<size_t>(Hkv) * kRowBytes;
    const size_t head = (static_cast<size_t>(b) * S * Hkv + g) * kRowBytes;
    const unsigned char* kg = static_cast<const unsigned char*>(k) + head;
    const unsigned char* vg = static_cast<const unsigned char*>(v) + head;
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages) wait_parity(empty + st, ((i / kStages) - 1) & 1);
      const int t0 = lo + i * kTile, valid = min(kTile, hi - t0);
      if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(sa(full + st)), "r"(2 * valid * kRowBytes) : "memory");
      __syncwarp();
      if (lane < valid) {
        unsigned char* kd = ring + st * kStageBytes + lane * kStride;
        const size_t off = static_cast<size_t>(t0 + lane) * stride;
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                     "[%0], [%1], %2, [%3];\n" ::"r"(sa(kd)), "l"(kg + off), "r"(kRowBytes),
                     "r"(sa(full + st)) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                     "[%0], [%1], %2, [%3];\n" ::"r"(sa(kd + kTileBytes)), "l"(vg + off),
                     "r"(kRowBytes), "r"(sa(full + st)) : "memory");
      }
    }
  } else {
    for (int i = warp; i < ntiles; i += kConsumers) {
      const int st = i % kStages;
      wait_parity(full + st, (i / kStages) & 1);
      __syncwarp();
      if (lane == 0) asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                                  ::"r"(sa(empty + st)) : "memory");
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[(static_cast<size_t>(b) * gridDim.y + g) * gridDim.x + s] = ring[0];
}
}  // namespace

// kind 0: cp_async_floor, 1: ring_floor.  Grid (splits, Hkv, B).  `smem`
// bytes of shared memory a CTA (its own need when smaller): more holds fewer
// CTAs on an SM.
extern "C" int floor_launch(int kind, const void* k, const void* v, const int* pos, int B, int S,
                            int Hkv, int splits, int rows, float* out, int smem, void* stream) {
  smem = max(smem, kind == 0 ? kOldBytes : kRingBytes);
  const dim3 grid(splits, Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    cudaFuncSetAttribute(cp_async_floor, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cp_async_floor<<<grid, kWarps * 32, smem, st>>>(k, v, pos, S, Hkv, rows, out);
  } else {
    cudaFuncSetAttribute(ring_floor, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ring_floor<<<grid, (kConsumers + 1) * 32, smem, st>>>(k, v, pos, S, Hkv, rows, out);
  }
  return cudaGetLastError();
}

extern "C" int floor_occupancy(int kind, int smem, int* ctas) {
  smem = max(smem, kind == 0 ? kOldBytes : kRingBytes);
  if (kind == 0) {
    cudaFuncSetAttribute(cp_async_floor, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, cp_async_floor, kWarps * 32, smem);
  }
  cudaFuncSetAttribute(ring_floor, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, ring_floor, (kConsumers + 1) * 32,
                                                       smem);
}
"""


def device_ms(fn, runs=15, per_run=25):
    """Median device ms of one ``fn()``: ``per_run`` calls queued behind a
    sleeping kernel, timed with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_copy_floor.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.build import BUILD_DIR, check_launch, load_library
    from repro_torch.kernels.decode_attention.decode_attention import split_count

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "attn_copy_floor.cu"
    src.write_text(SOURCE)
    lib = load_library(src)
    lib.floor_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.floor_launch.restype = ctypes.c_int
    lib.floor_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.floor_occupancy.restype = ctypes.c_int

    B, S, Hq, Hkv, D = SHAPE
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nbytes = 2 * B * S * Hkv * D * 2 + 2 * q.numel() * 2 + 4 * B
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    stream = torch.cuda.current_stream(dev).cuda_stream
    # ring_floor also with the shared memory of 2 and of 1 CTA an SM: a
    # producer that cannot keep up shows as a time that falls with the CTAs
    for kind, name, smem in ((0, "cp_async_floor", 0), (1, "ring_floor", 0),
                             (1, "ring_floor", 100 * 1024), (1, "ring_floor", 150 * 1024)):
        per_sm = ctypes.c_int(0)
        check_launch(lib.floor_occupancy(kind, smem, ctypes.byref(per_sm)), name)
        splits = split_count(B, Hq, Hkv, S, per_sm.value * sms)
        rows = -(-S // splits)
        out = torch.empty((B, Hkv, splits), dtype=torch.float32, device=dev)

        def run():
            check_launch(lib.floor_launch(kind, k.data_ptr(), v.data_ptr(), pos.data_ptr(), B,
                                          S, Hkv, splits, rows, out.data_ptr(), smem, stream),
                         name)

        print(f"{name}: {per_sm.value} CTAs an SM, {splits} splits of {rows} rows: "
              f"{device_ms(run)!r} ms (bound {bound!r} ms)", flush=True)
    print(f"decode_attention: {device_ms(lambda: decode_attention(q, k, v, pos))!r} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
