// graphFilter pack (edgeMapPack, paper section 4.2.2) for Hopper (sm_90a).
//
// Replaces the TPU kernel filter_pack_pallas
// (src/repro/kernels/filter_pack/filter_pack.py, body _kernel): for every
// block row of the graph filter,
//
//   keep_word[w] = bit l set  iff  keep[row, 32 w + l]   (little-endian)
//   new_bits[row, w] = subset[row] ? bits[row, w] & keep_word[w] : bits[row, w]
//   count[row] = popcount of new_bits[row, :]
//
// The segment sum of the counts by block owner stays in the Python wrapper,
// as on the TPU.  The graph itself is never read or written here: only the
// filter words (small memory) change.
//
// Bound on the H100: bandwidth, and a small one.  Per block it reads FB keep
// bytes, 4 W bytes of words and 1 byte of subset, and writes 4 W bytes of
// words and 4 of count: at FB = 128 (W = 4), 165 bytes a block, divided by
// 3.35 TB/s.  There is almost no arithmetic.
//
// Design: one warp per block row, `warps` rows per CTA (1..32), no padding:
// the last CTA's surplus warps exit on a bounds check.  For word w, lane l
// reads keep byte 32 w + l, so a warp reads 32 consecutive bytes, and
// __ballot_sync of (byte != 0) is exactly the little-endian keep word.  Every
// lane reads the same filter word (one broadcast load), so the AND and the
// __popc are uniform across the warp; lane w stores word w and lane 0 the
// count.  The TPU's (TB, FB) tiles and its padding of NB to a multiple of TB
// are not carried over.
// Left for later: the keep bytes are read one byte a lane (a row of 128 bytes
// in four 32-byte loads); 16-byte vector loads would need a bit transpose.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int W>
__global__ void __launch_bounds__(1024)
filter_pack_kernel(const uint32_t* __restrict__ bits,
                   const uint8_t* __restrict__ keep,
                   const uint8_t* __restrict__ subset,
                   int NB, int warps,
                   uint32_t* __restrict__ new_bits,
                   int32_t* __restrict__ count) {
  constexpr int FB = 32 * W;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * warps + (threadIdx.x >> 5);
  if (i >= NB) return;  // uniform across the warp
  const size_t row = static_cast<size_t>(i);
  const uint8_t* krow = keep + row * FB;
  const bool sub = subset[row] != 0;
  int total = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const unsigned kw = __ballot_sync(kFull, krow[32 * w + lane] != 0);
    uint32_t b = bits[row * W + w];
    if (sub) b &= kw;
    total += __popc(b);
    if (lane == w) new_bits[row * W + w] = b;
  }
  if (lane == 0) count[row] = total;
}

template <int W>
cudaError_t launch_w(int warps, cudaStream_t stream, const uint32_t* bits,
                     const uint8_t* keep, const uint8_t* subset, int NB,
                     uint32_t* new_bits, int32_t* count) {
  const dim3 grid((NB + warps - 1) / warps);
  const dim3 block(32 * warps);
  filter_pack_kernel<W><<<grid, block, 0, stream>>>(bits, keep, subset, NB, warps, new_bits,
                                                    count);
  return cudaGetLastError();
}

}  // namespace

// bits (NB, FB/32) words, keep (NB, FB) bytes (0 or 1), subset (NB,) bytes;
// writes new_bits (NB, FB/32) and count (NB,).  `warps` rows per CTA (1..32).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int filter_pack_launch(const uint32_t* bits, const uint8_t* keep,
                                  const uint8_t* subset, int NB, int FB, int warps,
                                  uint32_t* new_bits, int32_t* count, void* stream) {
  if (NB <= 0) return 0;
  if (warps < 1 || warps > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (FB) {
    case 32:
      return launch_w<1>(warps, s, bits, keep, subset, NB, new_bits, count);
    case 64:
      return launch_w<2>(warps, s, bits, keep, subset, NB, new_bits, count);
    case 128:
      return launch_w<4>(warps, s, bits, keep, subset, NB, new_bits, count);
    default:
      return cudaErrorInvalidValue;
  }
}
