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
// Design: a lane loads 16 keep bytes as one uint4, so a row is FB / 16
// lanes (8 at FB = 128) and a warp covers 512 / FB rows with one load a
// lane; it takes kGroups such groups of rows (consecutive, so the warp's
// keep bytes are one contiguous run) and has all their loads in flight
// before it uses any.  The subset bytes and filter words come first, then
// the keep bytes of the subset rows only.  A keep byte is 0 or 1 (torch.bool),
// so a 32-bit word of four of them becomes four bits with one multiply:
// (u * 0x01020408) >> 24 puts byte i's bit at bit i (the partial products
// land on distinct bits, so nothing carries into them).  Four such nibbles are
// a lane's 16 bits, and the even lane of a pair joins its odd neighbour's 16
// with one __shfl_xor_sync: the pair's word, little-endian.  The even lane
// ANDs it into the row's filter word (on subset rows), stores it and
// counts it with __popc; a shuffle sum over the row's lanes (3 steps at
// FB = 128) gives the row's count to its first lane.  NB needs no padding:
// lanes past NB load and store nothing.  The wrapper checks that keep is
// 16-byte aligned.  2, 4 and 8 groups in flight were timed on graph A's
// filter: within 3 % of each other (0.0441, 0.0447, 0.0455 ms; NVIDIA H100
// 80GB HBM3, 700 W).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroups = 4;  // row groups a warp has in flight

// bits 0..15 of the result: the 16 bool bytes of v, byte i at bit i
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  const uint32_t a = (v.x * 0x01020408u) >> 24;
  const uint32_t b = (v.y * 0x01020408u) >> 24;
  const uint32_t c = (v.z * 0x01020408u) >> 24;
  const uint32_t d = (v.w * 0x01020408u) >> 24;
  return (a & 0xfu) | ((b & 0xfu) << 4) | ((c & 0xfu) << 8) | ((d & 0xfu) << 12);
}

template <int W>
__global__ void __launch_bounds__(1024)
filter_pack_kernel(const uint32_t* __restrict__ bits,
                   const uint8_t* __restrict__ keep,
                   const uint8_t* __restrict__ subset,
                   int NB, int warps,
                   uint32_t* __restrict__ new_bits,
                   int32_t* __restrict__ count) {
  constexpr int FB = 32 * W;
  constexpr int LPR = FB / 16;        // lanes a row
  constexpr int RPG = 32 / LPR;       // rows a group: one uint4 a lane
  constexpr int RPW = RPG * kGroups;  // rows a warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;         // the lane's 16 slots of its row
  const long long warp = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5);
  const long long r0 = warp * RPW + lane / LPR;
  if (warp * RPW >= NB) return;  // uniform across the warp
  const bool even = (sub & 1) == 0;   // holds word sub / 2 of its row
  bool in[kGroups], sel[kGroups];
  uint32_t word[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long row = r0 + g * RPG;
    in[g] = row < NB;
    sel[g] = in[g] && __ldcs(subset + row) != 0;
    word[g] = in[g] && even ? __ldcs(bits + row * W + sub / 2) : 0u;
  }
  uint4 kv[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long row = r0 + g * RPG;
    kv[g] = sel[g] ? __ldcs(reinterpret_cast<const uint4*>(keep + row * FB) + sub)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long row = r0 + g * RPG;
    const uint32_t half = pack16(kv[g]);
    const uint32_t other = __shfl_xor_sync(kFull, half, 1);
    int c = 0;
    if (in[g] && even) {
      const uint32_t b = sel[g] ? word[g] & (half | (other << 16)) : word[g];
      new_bits[row * W + sub / 2] = b;
      c = __popc(b);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
    if (in[g] && sub == 0) count[row] = c;
  }
}

template <int W>
cudaError_t launch_w(int warps, cudaStream_t stream, const uint32_t* bits,
                     const uint8_t* keep, const uint8_t* subset, int NB,
                     uint32_t* new_bits, int32_t* count) {
  constexpr int rows_per_warp = (32 / (2 * W)) * kGroups;
  const long long warps_needed = (NB + rows_per_warp - 1) / rows_per_warp;
  const dim3 grid(static_cast<unsigned>((warps_needed + warps - 1) / warps));
  const dim3 block(32 * warps);
  filter_pack_kernel<W><<<grid, block, 0, stream>>>(bits, keep, subset, NB, warps, new_bits,
                                                    count);
  return cudaGetLastError();
}

}  // namespace

// bits (NB, FB/32) words, keep (NB, FB) bytes (0 or 1, 16-byte aligned),
// subset (NB,) bytes; writes new_bits (NB, FB/32) and count (NB,).  `warps`
// warps per CTA (1..32), each 4 groups of 512 / FB rows.  Returns the
// cudaError_t of the launch (0 on success).
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
