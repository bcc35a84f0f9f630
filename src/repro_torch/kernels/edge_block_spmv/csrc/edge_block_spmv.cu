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
// Bound on the H100: bandwidth.  Every block reads its whole row, 4*FB bytes
// of targets and 4*FB of weights (the kernel learns which slots are real only
// from the targets), plus 4*FB/32 per mask, and writes 4*B bytes; x (n*4*B
// bytes) is gathered from the 50 MB L2.  At FB = 128 that is 1,040 bytes a
// block with the filter bits: divide by 3.35 TB/s.
//
// Design: one warp per block, tile_blocks warps per CTA (1..32).  Each lane
// holds FB/32 consecutive slots, loaded as one vector per row (16 bytes of
// targets and 16 of weights at FB = 128, so a 512-byte row is one coalesced
// pass of the warp).  The batch of B queries is a loop inside the warp over
// the same registers, and a block's sum is a __shfl_xor_sync tree.  float32 x
// sums in float32; int32 x is multiplied by the float weights and summed in
// float32, then truncated to int32, as the reference does.  No array is
// padded: the last CTA's surplus warps exit on a bounds check.
// Left for later: no cp.async/TMA staging of the next rows, the grid is not
// persistent, and x is gathered from L2 rather than staged in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

enum Mode { kFloat = 1, kInt = 2 };

template <int S>
__device__ __forceinline__ void load_row(const int32_t* drow, const float* wrow, int lane,
                                         int32_t (&d)[S], float (&w)[S]) {
  if constexpr (S == 4) {
    const int4 dv = reinterpret_cast<const int4*>(drow)[lane];
    const float4 wv = reinterpret_cast<const float4*>(wrow)[lane];
    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
    w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
  } else if constexpr (S == 2) {
    const int2 dv = reinterpret_cast<const int2*>(drow)[lane];
    const float2 wv = reinterpret_cast<const float2*>(wrow)[lane];
    d[0] = dv.x; d[1] = dv.y;
    w[0] = wv.x; w[1] = wv.y;
  } else {
    d[0] = drow[lane];
    w[0] = wrow[lane];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int S, int MODE>
__global__ void __launch_bounds__(1024)
edge_block_kernel(const int32_t* __restrict__ block_dst,
                  const float* __restrict__ block_w,
                  const uint32_t* __restrict__ bits,
                  const uint32_t* __restrict__ edge_active,
                  int NB, int n, int warps,
                  const void* __restrict__ x, int B, long long x_stride,
                  void* __restrict__ out) {
  constexpr int FB = 32 * S;
  constexpr int W = FB / 32;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * warps + (threadIdx.x >> 5);
  if (i >= NB) return;  // uniform across the warp
  const size_t row = static_cast<size_t>(i);
  int32_t dst[S];
  float w[S];
  load_row<S>(block_dst + row * FB, block_w + row * FB, lane, dst, w);
  const int word = (lane * S) >> 5;  // all S slots of a lane share one word
  uint32_t bw = 0xffffffffu, aw = 0xffffffffu;
  if (bits != nullptr) bw = bits[row * W + word];
  if (edge_active != nullptr) aw = edge_active[row * W + word];
  bool m[S];
  int32_t safe[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = lane * S + s;
    m[s] = (dst[s] < n) && ((bw >> (j & 31)) & 1u) && ((aw >> (j & 31)) & 1u);
    safe[s] = m[s] ? dst[s] : 0;
  }
  for (int b = 0; b < B; ++b) {
    const size_t off = static_cast<size_t>(b) * x_stride;
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float v;
      if constexpr (MODE == kFloat) {
        v = static_cast<const float*>(x)[off + safe[s]];
      } else {
        v = static_cast<float>(static_cast<const int32_t*>(x)[off + safe[s]]);
      }
      acc += m[s] ? v * w[s] : 0.0f;
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const size_t o = row * B + b;
      if constexpr (MODE == kFloat) {
        static_cast<float*>(out)[o] = acc;
      } else {
        static_cast<int32_t*>(out)[o] = static_cast<int32_t>(acc);
      }
    }
  }
}

template <int S>
cudaError_t launch_s(int mode, int warps, cudaStream_t stream, const int32_t* block_dst,
                     const float* block_w, const uint32_t* bits, const uint32_t* active,
                     int NB, int n, const void* x, int B, long long x_stride, void* out) {
  const dim3 grid((NB + warps - 1) / warps);
  const dim3 block(32 * warps);
  switch (mode) {
    case kFloat:
      edge_block_kernel<S, kFloat><<<grid, block, 0, stream>>>(
          block_dst, block_w, bits, active, NB, n, warps, x, B, x_stride, out);
      break;
    case kInt:
      edge_block_kernel<S, kInt><<<grid, block, 0, stream>>>(
          block_dst, block_w, bits, active, NB, n, warps, x, B, x_stride, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// mode: 1 float32 x, 2 int32 x.  Null pointers mark absent masks.  `warps`
// blocks per CTA (1..32).  out is (NB,) or (NB, B) of x's dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int edge_block_spmv_launch(const int32_t* block_dst, const float* block_w,
                                      const uint32_t* bits, const uint32_t* edge_active,
                                      int NB, int FB, int n, int mode, int warps,
                                      const void* x, int B, long long x_stride, void* out,
                                      void* stream) {
  if (NB <= 0) return 0;
  if (warps < 1 || warps > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (FB) {
    case 32:
      return launch_s<1>(mode, warps, s, block_dst, block_w, bits, edge_active, NB, n, x, B,
                         x_stride, out);
    case 64:
      return launch_s<2>(mode, warps, s, block_dst, block_w, bits, edge_active, NB, n, x, B,
                         x_stride, out);
    case 128:
      return launch_s<4>(mode, warps, s, block_dst, block_w, bits, edge_active, NB, n, x, B,
                         x_stride, out);
    default:
      return cudaErrorInvalidValue;
  }
}
