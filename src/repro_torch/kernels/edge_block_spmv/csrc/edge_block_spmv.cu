// Masked SpMV over the uncompressed blocked CSR, for Hopper (sm_90a).
//
// Replaces the TPU kernel edge_block_spmv_pallas
// (src/repro/kernels/edge_block_spmv/edge_block_spmv.py, body _kernel): the
// pull SpMV behind spmv_vertex.  For every block row of the graph:
//
//   mask   = dst < n  AND  bit of bits[row]  AND  bit of edge_active[row]
//   out[i, b] = sum over slots of mask ? w * x[b, dst] : 0
//
// The owner reduction by block_src stays in the Python wrapper, as on the TPU.
//
// Bound on the H100: bandwidth.  A vertex's edges fill its blocks from the
// front, so block i of owner v = block_src[i] holds
//   min(FB, degrees[v] - (i - block_offsets[v]) * FB)
// real slots and the sentinel n after them (none when v >= n: the dummy
// block of an edgeless graph, a shard's padding).  Given those three arrays
// (`block_src` non-NULL) the kernel reads 4 B of owner a block, 8 B a real
// slot (target, weight) and the filter words that cover the real slots;
// without them it reads whole rows, 8*FB B a block, and learns which slots
// are real from the targets alone.  x is gathered from the 50 MB L2; each
// output is written once.  R-MAT's graph at n = 2^20, m = 2^24 fills ~30 %
// of its slots, so reading only the real slots cuts the bytes ~3x.
//
// Design: a warp takes a tile of 32 consecutive blocks; lane k derives
// block k's real-slot count (two dependent loads, paid once for 32
// blocks).  Groups of 8 lanes then take the tile's blocks 4 at a time: a
// lane holds 4 consecutive slots a pass (16 B of targets and 16 of weights,
// so a group's pass is one 128-byte line and one filter word), and all
// FB/32 passes of a block are loaded before any x is gathered, so a round
// costs two round trips (row, then x) whatever the block's size.  Loads past
// the count are predicated off, words included.  Rows stream (evict first),
// so L1 and L2 keep x: the gathers, a 32-byte sector for 4 bytes, are what
// the card spends most on here, and their L1 hits count.  The grid has a
// warp for every tile, so the card's scheduler balances the tiles: a
// persistent grid whose warps walked 6 or 7 tiles each ran its last tiles
// on a tenth of the warps, and was slower at n = 2^20.  A batch of
// B queries reuses the registers of the row, QB (1 or 4) queries at a
// time, and a block's sum is a __shfl_xor_sync tree over its group.
// float32 x sums in float32; int32 x is multiplied by the float weights and
// summed in float32, then truncated to int32, as the reference does.  No
// array is padded: lanes past NB count 0 slots and store nothing.
// Measured slower on this card: lanes on strided slots (4x the row loads),
// a flat run of each tile's real slots (shuffle-bound), x's first ids in
// shared memory (it takes L1's room), the next tile's owners loaded early.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;              // consecutive blocks a warp takes: a lane each
constexpr int kLanes = 8;              // lanes a block: 8 x 16 B, one 128-byte line
constexpr int kAtOnce = 32 / kLanes;   // blocks a warp holds at once
constexpr int kSpan = 4 * kLanes;      // slots a group covers a pass: one filter word

enum Mode { kFloat = 1, kInt = 2 };

template <int MODE>
__device__ __forceinline__ float x_at(const void* x, long long i) {
  if constexpr (MODE == kFloat) {
    return __ldg(static_cast<const float*>(x) + i);
  } else {
    return static_cast<float>(__ldg(static_cast<const int32_t*>(x) + i));
  }
}

// Real slots of block i: FB without the owner arrays, else what its owner's
// degree leaves for it, clamped to [0, FB] so a row is never overrun.
__device__ __forceinline__ int real_slots(int i, int FB, int n, const int32_t* block_src,
                                          const int32_t* block_offsets,
                                          const int32_t* degrees) {
  if (block_src == nullptr) return FB;
  const int v = __ldg(block_src + i);
  if (v < 0 || v >= n) return 0;  // degrees has n entries
  const int c = __ldg(degrees + v) - (i - __ldg(block_offsets + v)) * FB;
  return min(max(c, 0), FB);
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int FB, int MODE, int QB>
__global__ void __launch_bounds__(1024, 1)
edge_block_kernel(const int32_t* __restrict__ block_dst,
                  const float* __restrict__ block_w,
                  const uint32_t* __restrict__ bits,
                  const uint32_t* __restrict__ edge_active,
                  const int32_t* __restrict__ block_src,
                  const int32_t* __restrict__ block_offsets,
                  const int32_t* __restrict__ degrees,
                  int NB, int n,
                  const void* __restrict__ x, int B, long long x_stride,
                  void* __restrict__ out) {
  constexpr int P = FB / kSpan;  // passes a full block takes = its filter words
  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;
  const int sub = lane % kLanes;
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (t >= (NB + kTile - 1) / kTile) return;  // uniform across the warp
  const int base = t * kTile;
  const int count = base + lane < NB
      ? real_slots(base + lane, FB, n, block_src, block_offsets, degrees) : 0;
#pragma unroll 1
  for (int k0 = 0; k0 < kTile; k0 += kAtOnce) {
    const int k = k0 + group;
    const int i = base + k;
    const int cnt = __shfl_sync(kFull, count, k);
    const size_t row = static_cast<size_t>(i) * FB;
    // every pass's loads first, then their uses: nothing waits on a load
    // before the last one has been issued
    int4 dv[P];
    float4 wv[P];
    uint32_t word[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j0 = p * kSpan + sub * 4;
      dv[p] = make_int4(-1, -1, -1, -1);
      wv[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      word[p] = kFull;
      if (j0 < cnt) {
        dv[p] = __ldcs(reinterpret_cast<const int4*>(block_dst + row + j0));
        wv[p] = __ldcs(reinterpret_cast<const float4*>(block_w + row + j0));
        if (bits != nullptr) word[p] = __ldcs(bits + static_cast<size_t>(i) * P + p);
        if (edge_active != nullptr) {
          word[p] &= __ldcs(edge_active + static_cast<size_t>(i) * P + p);
        }
      }
    }
    int dst[P][4];
    float w[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int d4[4] = {dv[p].x, dv[p].y, dv[p].z, dv[p].w};
      const float w4[4] = {wv[p].x, wv[p].y, wv[p].z, wv[p].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = p * kSpan + sub * 4 + e;
        const bool m = j < cnt && d4[e] >= 0 && d4[e] < n && ((word[p] >> (j & 31)) & 1u);
        dst[p][e] = m ? d4[e] : -1;  // -1: masked, x not read
        w[p][e] = w4[e];
      }
    }
    for (int q0 = 0; q0 < B; q0 += QB) {
      float acc[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        acc[u] = 0.0f;
        if (QB > 1 && q0 + u >= B) continue;  // uniform across the warp
        const long long off = static_cast<long long>(q0 + u) * x_stride;
        float xv[P][4];  // all gathers of the round in flight before the sum
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xv[p][e] = dst[p][e] >= 0 ? x_at<MODE>(x, off + dst[p][e]) : 0.0f;
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[u] += dst[p][e] >= 0 ? xv[p][e] * w[p][e] : 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) acc[u] = group_sum(acc[u]);
      if (sub == 0 && i < NB) {
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          if (QB == 1 || q0 + u < B) {
            const size_t o = static_cast<size_t>(i) * B + q0 + u;
            if constexpr (MODE == kFloat) {
              static_cast<float*>(out)[o] = acc[u];
            } else {
              static_cast<int32_t*>(out)[o] = static_cast<int32_t>(acc[u]);
            }
          }
        }
      }
    }
  }
}

template <int FB, int MODE, int QB>
cudaError_t launch(int warps, cudaStream_t stream, const int32_t* block_dst,
                   const float* block_w, const uint32_t* bits, const uint32_t* active,
                   const int32_t* block_src, const int32_t* block_offsets,
                   const int32_t* degrees, int NB, int n, const void* x, int B,
                   long long x_stride, void* out) {
  const long long tiles = (NB + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>((tiles + warps - 1) / warps));  // a warp a tile
  edge_block_kernel<FB, MODE, QB><<<grid, 32 * warps, 0, stream>>>(
      block_dst, block_w, bits, active, block_src, block_offsets, degrees, NB, n, x, B,
      x_stride, out);
  return cudaGetLastError();
}

template <int FB>
cudaError_t launch_fb(int mode, int warps, cudaStream_t s, const int32_t* block_dst,
                      const float* block_w, const uint32_t* bits, const uint32_t* active,
                      const int32_t* block_src, const int32_t* block_offsets,
                      const int32_t* degrees, int NB, int n, const void* x, int B,
                      long long x_stride, void* out) {
#define EDGE_LAUNCH(MODE, QB)                                                             \
  launch<FB, MODE, QB>(warps, s, block_dst, block_w, bits, active, block_src,             \
                       block_offsets, degrees, NB, n, x, B, x_stride, out)
  switch (mode) {
    case kFloat:
      return B == 1 ? EDGE_LAUNCH(kFloat, 1) : EDGE_LAUNCH(kFloat, 4);
    case kInt:
      return B == 1 ? EDGE_LAUNCH(kInt, 1) : EDGE_LAUNCH(kInt, 4);
    default:
      return cudaErrorInvalidValue;
  }
#undef EDGE_LAUNCH
}

}  // namespace

// mode: 1 float32 x, 2 int32 x.  Null pointers mark absent masks, and a null
// block_src absent owner arrays (block_src (NB,), block_offsets (n+1,),
// degrees (n,), all three or none): whole rows are read.  `warps` warps a
// CTA (1..32).  block_dst and block_w are 16-byte aligned.  out is (NB,) or
// (NB, B) of x's dtype.  Returns the cudaError_t of the launch (0 on success).
extern "C" int edge_block_spmv_launch(const int32_t* block_dst, const float* block_w,
                                      const uint32_t* bits, const uint32_t* edge_active,
                                      const int32_t* block_src, const int32_t* block_offsets,
                                      const int32_t* degrees,
                                      int NB, int FB, int n, int mode, int warps,
                                      const void* x, int B, long long x_stride, void* out,
                                      void* stream) {
  if (NB <= 0) return 0;
  if (warps < 1 || warps > 32 || B < 1) return cudaErrorInvalidValue;
  if ((block_src == nullptr) != (block_offsets == nullptr) ||
      (block_src == nullptr) != (degrees == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(block_dst) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(block_w) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (FB) {
    case 32:
      return launch_fb<32>(mode, warps, s, block_dst, block_w, bits, edge_active, block_src,
                           block_offsets, degrees, NB, n, x, B, x_stride, out);
    case 64:
      return launch_fb<64>(mode, warps, s, block_dst, block_w, bits, edge_active, block_src,
                           block_offsets, degrees, NB, n, x, B, x_stride, out);
    case 128:
      return launch_fb<128>(mode, warps, s, block_dst, block_w, bits, edge_active, block_src,
                            block_offsets, degrees, NB, n, x, B, x_stride, out);
    default:
      return cudaErrorInvalidValue;
  }
}
