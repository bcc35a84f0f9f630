// Decode of compressed graph blocks fused with the masked SpMV, for Hopper (sm_90a).
//
// Three kernels:
//
// 1. chunked_kernel replaces the TPU kernel compressed_chunked_spmv_pallas
//    (src/repro/kernels/compressed_spmv/compressed_spmv.py, body _chunked_kernel,
//    tiled grid _chunked_tiled_call): it decodes only the blocks named by one
//    chunk of the compacted live-block id list, a warp a block (decode_row).
// 1b. stream_round_kernel does all of one sparse_streamed edgeMap round in one
//    launch, where the TPU runs the chunk loop of _chunked_kernel launches
//    inside a lax.while_loop: liveness of every block, the decode of the live
//    ones, and the round's min over int32 with the identity map (BFS) or the
//    saturating add (wBFS), applied with atomics.
// 2. block_kernel replaces the TPU kernel compressed_block_spmv_pallas
//    (same file, body _kernel): it sums every block of the graph, the pull
//    SpMV behind compressed_spmv_vertex and calibration's tile sweep.
//
// For a block row:
//
//   dst  = block_first[row] + inclusive_cumsum(deltas[row]) with slot 0 zeroed
//   mask = slot < valid_count[row]  AND  bit of bits[row]  AND  bit of edge_active[row]
//   emit == decode : dst_out = (mask && dst < n) ? dst : n ; w_out = weight row
//                    (1.0 when unweighted, 0.0 on a pad row of a weighted graph)
//   emit == sums   : out[i, b] = sum over slots of mask ? w * x[b, safe(dst)] : 0
//
// An id >= NB (or negative) is a pad row of the chunked kernel: it decodes to
// all n and reads no graph array.  Blocks holding ESCAPE deltas decode wrong on
// purpose; the Python wrappers patch them from the exception list, as on the TPU.
// stream_round_kernel reads those blocks' exact rows instead (exc_row).
//
// Bound on the H100: all three kernels are bandwidth-bound.  Per block they read
// 4 + 2 bytes (first target, valid count), 2 bytes of deltas per valid slot,
// 4*ceil(vc/32) per mask and 4 per valid slot if weighted; a lane reads no
// delta or weight slot past valid_count (the scan gives those slots targets
// no mask lets through).  decode writes 8*FB bytes per id.  Divide by
// 3.35 TB/s.  sums also gathers x[dst] (256 KB to 4 MB here, resident in the
// 50 MB L2) and writes 4*B bytes per block.  stream_round_kernel reads
// 4 + B bytes a block (owner, its frontier bytes) to find the live ones and
// the above of the live ones only (weights only for the saturating add); its
// per-slot min goes to the (n, B) state in L2.
//
// chunked_kernel: one warp per block, 8 warps a CTA.  Each lane holds FB/32
// consecutive slots, loaded as one vector when all of them are valid; the
// prefix sum is a local prefix plus a warp inclusive scan (__shfl_up_sync) of
// the lane totals, in 32-bit unsigned arithmetic so it wraps exactly like the
// int32 cumsum of the reference.  sums loops over the B queries inside the
// warp, so a block is decoded once for the whole batch.
//
// block_kernel: a warp takes a tile of 32 consecutive blocks (4 for a batch
// of queries); lane k loads block k's valid count and first target (one
// coalesced load of each per tile, and the count is stored, so nothing is
// derived).  Groups of L lanes then take the tile's blocks 32 / L at a
// time, a lane FB / L consecutive slots (L = 16 at FB = 128, else 8: with 8
// lanes and 16 slots a lane the F_B = 128 builds spilled under the
// 64-register cap of 1024-thread CTAs).  All of a round's deltas,
// weights and filter words are loaded before any is used, in chunks of
// FB/32 slots (the widths the wrapper's alignment checks guarantee), and a
// chunk past valid_count is not loaded.  Rows stream (__ldcs), so that L1
// and L2 keep x.  The prefix is the lane's own plus an L-lane
// __shfl_up_sync scan (3 or 4 steps, not 5), in uint32.  All of a round's
// x gathers are in flight before the sum; a batch of B queries reuses the
// decoded row, QB = 2 queries at a time (1 for one query), each an L-lane
// __shfl_xor_sync sum.  int32 unweighted sums stay uint32 (exact,
// wrapping); int32 weighted sums are float, truncated, as the reference's
// are.  The grid has a warp for every tile, tile_blocks warps a CTA (1..32,
// the knob calibration sweeps), and no persistent loop: the card balances
// the tiles.  No array is padded: lanes past NB load nothing and store
// nothing.
//
// stream_round_kernel: the lane groups of block_kernel, a warp a tile of
// kRoundTile = 8 blocks.  Lane k < 8 loads block k's owner and tests its
// frontier bytes (the OR over the B queries); a __ballot_sync gives the
// tile's live set, and a tile with none exits after 4 + B bytes a block.
// Only live lanes load their header (and exc_row); the groups then take the
// live blocks, lowest first, 32 / L at a time.  A block on the exception list
// reads its exact, active-masked row of targets instead of its deltas.  For
// every masked-in slot and every query b whose frontier holds the block's
// owner, v = map(x[b, owner], w) is min-ed into out[dst, b] with atomicMin,
// after a plain load shows that out does not already hold v or less: R-MAT's
// hubs take many slots each.  The load may come from L1 and be stale, but
// out only falls during the round, so a stale value costs at most an
// atomic.  A block's targets are distinct, so all of its slots' loads are in
// flight before the first atomic, and the atomics return nothing (RED).
// touched[dst, b] is stored where the atomic ran or v is the identity: a
// slot whose atomic is skipped meets a value that a slot with an atomic
// wrote in this round, and that slot stored touched.  min over int32 is
// order-free, so out and touched are exactly the chunk loop's.  Tiles of
// 8, 4, 16 and 32 blocks, loads through L2 only (__ldcg) and launch bounds
// of 3 or 4 CTAs an SM were timed on graph B: loads through L1 took a
// full-frontier round from 0.27 to 0.09 ms; the rest moved it by 15 % or less,
// in either direction, and 3 CTAs an SM slowed B = 8.
// Left for later: chunked_kernel keeps a warp a block and one round trip
// after another (stream_round_kernel took its place on BFS and wBFS
// rounds); x is gathered from L2, not staged in shared memory.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kChunkWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kDecode = 0, kSumsFloat = 1, kSumsInt = 2, kSumsIntWeighted = 3 };

// The S slots of this lane that lie below valid_count, 0 above it: one vector
// load when all S are valid, single loads when some are, none when none are.
template <int S>
__device__ __forceinline__ void load_deltas(const uint16_t* row, int lane, int vc,
                                            uint32_t (&d)[S]) {
  const int j0 = lane * S;
  if (j0 + S <= vc) {
    if constexpr (S == 4) {
      const uint2 v = reinterpret_cast<const uint2*>(row)[lane];
      d[0] = v.x & 0xffffu; d[1] = v.x >> 16; d[2] = v.y & 0xffffu; d[3] = v.y >> 16;
    } else if constexpr (S == 2) {
      const uint32_t v = reinterpret_cast<const uint32_t*>(row)[lane];
      d[0] = v & 0xffffu; d[1] = v >> 16;
    } else {
      d[0] = row[lane];
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) d[s] = (j0 + s < vc) ? row[j0 + s] : 0u;
  }
}

// The whole weight row slice of this lane (decode emits it as stored).
template <int S>
__device__ __forceinline__ void load_weights(const float* row, int lane, float (&w)[S]) {
  if constexpr (S == 4) {
    const float4 v = reinterpret_cast<const float4*>(row)[lane];
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (S == 2) {
    const float2 v = reinterpret_cast<const float2*>(row)[lane];
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = row[lane];
  }
}

// The weights of the valid slots only, 0 above valid_count (sums mask those).
template <int S>
__device__ __forceinline__ void load_valid_weights(const float* row, int lane, int vc,
                                                   float (&w)[S]) {
  const int j0 = lane * S;
  if (j0 + S <= vc) {
    load_weights<S>(row, lane, w);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = (j0 + s < vc) ? row[j0 + s] : 0.0f;
  }
}

template <int S>
__device__ __forceinline__ void store_row(int32_t* drow, float* wrow, int lane,
                                          const int32_t (&d)[S], const float (&w)[S]) {
  if constexpr (S == 4) {
    reinterpret_cast<int4*>(drow)[lane] = make_int4(d[0], d[1], d[2], d[3]);
    reinterpret_cast<float4*>(wrow)[lane] = make_float4(w[0], w[1], w[2], w[3]);
  } else if constexpr (S == 2) {
    reinterpret_cast<int2*>(drow)[lane] = make_int2(d[0], d[1]);
    reinterpret_cast<float2*>(wrow)[lane] = make_float2(w[0], w[1]);
  } else {
    drow[lane] = d[0];
    wrow[lane] = w[0];
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The warp decode of block `row`: targets and mask of this lane's S slots,
// and the block's valid count.  All 32 lanes of the warp must call it.
template <int S>
__device__ __forceinline__ int decode_row(size_t row, int lane,
                                          const int32_t* __restrict__ block_first,
                                          const uint16_t* __restrict__ deltas,
                                          const uint16_t* __restrict__ valid_count,
                                          const uint32_t* __restrict__ bits,
                                          const uint32_t* __restrict__ edge_active,
                                          int32_t (&dst)[S], bool (&m)[S]) {
  constexpr int FB = 32 * S;
  constexpr int W = FB / 32;
  const int vc = valid_count[row];
  uint32_t d[S];
  load_deltas<S>(deltas + row * FB, lane, vc, d);
  if (lane == 0) d[0] = 0;
  uint32_t pre[S];
  uint32_t total = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) { total += d[s]; pre[s] = total; }
  uint32_t incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const uint32_t base = static_cast<uint32_t>(block_first[row]) + (incl - total);
  uint32_t bw = 0xffffffffu, aw = 0xffffffffu;
  const int word = (lane * S) >> 5;  // all S slots of a lane share one word
  if (lane * S < vc) {
    if (bits != nullptr) bw = bits[row * W + word];
    if (edge_active != nullptr) aw = edge_active[row * W + word];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = lane * S + s;
    dst[s] = static_cast<int32_t>(base + pre[s]);
    m[s] = (j < vc) && ((bw >> (j & 31)) & 1u) && ((aw >> (j & 31)) & 1u);
  }
  return vc;
}

// out[o * B + b] = sum over this warp's slots of the masked x[b, dst] (times w).
template <int S, int MODE>
__device__ __forceinline__ void emit_sums(size_t o, int lane, int n, const int32_t (&dst)[S],
                                          const bool (&m)[S], const float (&w)[S],
                                          const void* __restrict__ x, int B,
                                          long long x_stride, void* __restrict__ sums_out) {
  int32_t safe[S];
#pragma unroll
  for (int s = 0; s < S; ++s) safe[s] = (m[s] && dst[s] < n) ? dst[s] : 0;
  for (int b = 0; b < B; ++b) {
    const size_t off = static_cast<size_t>(b) * x_stride;
    const size_t out = o * B + b;
    if constexpr (MODE == kSumsInt) {
      const int32_t* xb = static_cast<const int32_t*>(x) + off;
      uint32_t acc = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) acc += m[s] ? static_cast<uint32_t>(xb[safe[s]]) : 0u;
      acc = warp_sum(acc);
      if (lane == 0) static_cast<int32_t*>(sums_out)[out] = static_cast<int32_t>(acc);
    } else {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float v;
        if constexpr (MODE == kSumsFloat) {
          v = static_cast<const float*>(x)[off + safe[s]];
        } else {
          v = static_cast<float>(static_cast<const int32_t*>(x)[off + safe[s]]);
        }
        acc += m[s] ? v * w[s] : 0.0f;
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        if constexpr (MODE == kSumsFloat) {
          static_cast<float*>(sums_out)[out] = acc;
        } else {
          static_cast<int32_t*>(sums_out)[out] = static_cast<int32_t>(acc);
        }
      }
    }
  }
}

template <int S, int MODE>
__global__ void __launch_bounds__(32 * kChunkWarps)
chunked_kernel(const int32_t* __restrict__ ids, int C,
               const int32_t* __restrict__ block_first,
               const uint16_t* __restrict__ deltas,
               const uint16_t* __restrict__ valid_count,
               const uint32_t* __restrict__ bits,
               const uint32_t* __restrict__ edge_active,
               const float* __restrict__ block_weights,
               int NB, int n,
               const void* __restrict__ x, int B, long long x_stride,
               int32_t* __restrict__ dst_out, float* __restrict__ w_out,
               void* __restrict__ sums_out) {
  constexpr int FB = 32 * S;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kChunkWarps + (threadIdx.x >> 5);
  if (i >= C) return;  // uniform across the warp
  const int id = ids[i];
  const bool pad = static_cast<unsigned>(id) >= static_cast<unsigned>(NB);

  int32_t dst[S];
  bool m[S];
  float w[S];
  if (pad) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      dst[s] = n;
      m[s] = false;
      w[s] = block_weights != nullptr ? 0.0f : 1.0f;
    }
  } else {
    const size_t row = static_cast<size_t>(id);
    const int vc = decode_row<S>(row, lane, block_first, deltas, valid_count, bits,
                                 edge_active, dst, m);
    if (block_weights == nullptr) {
#pragma unroll
      for (int s = 0; s < S; ++s) w[s] = 1.0f;
    } else if constexpr (MODE == kDecode) {
      load_weights<S>(block_weights + row * FB, lane, w);
    } else {
      load_valid_weights<S>(block_weights + row * FB, lane, vc, w);
    }
  }

  if constexpr (MODE == kDecode) {
    int32_t out[S];
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = (m[s] && dst[s] < n) ? dst[s] : n;
    store_row<S>(dst_out + static_cast<size_t>(i) * FB, w_out + static_cast<size_t>(i) * FB,
                 lane, out, w);
  } else {
    emit_sums<S, MODE>(static_cast<size_t>(i), lane, n, dst, m, w, x, B, x_stride, sums_out);
  }
}

// ---- block_kernel: every block of the graph, a warp a tile of 32 ----------

// S slots of this lane, [j, j + S): S deltas in one load when all lie below
// cnt, one by one when some do, none (0) when none do.
template <int S>
__device__ __forceinline__ void load_delta_chunk(const uint16_t* row, int j, int cnt,
                                                 uint32_t* d) {
  if (j + S <= cnt) {
    if constexpr (S == 4) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(row + j));
      d[0] = v.x & 0xffffu; d[1] = v.x >> 16; d[2] = v.y & 0xffffu; d[3] = v.y >> 16;
    } else if constexpr (S == 2) {
      const uint32_t v = __ldcs(reinterpret_cast<const unsigned int*>(row + j));
      d[0] = v & 0xffffu; d[1] = v >> 16;
    } else {
      d[0] = __ldcs(row + j);
    }
  } else {
#pragma unroll
    for (int e = 0; e < S; ++e) d[e] = j + e < cnt ? __ldcs(row + j + e) : 0u;
  }
}

// The same for weights (0 past cnt).
template <int S>
__device__ __forceinline__ void load_weight_chunk(const float* row, int j, int cnt, float* w) {
  if (j + S <= cnt) {
    if constexpr (S == 4) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(row + j));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (S == 2) {
      const float2 v = __ldcs(reinterpret_cast<const float2*>(row + j));
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = __ldcs(row + j);
    }
  } else {
#pragma unroll
    for (int e = 0; e < S; ++e) w[e] = j + e < cnt ? __ldcs(row + j + e) : 0.0f;
  }
}

template <int L, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// T: consecutive blocks a warp takes (32 or 4), a lane's count and first
// target each.
template <int S, int MODE, int QB, int T>
__global__ void __launch_bounds__(1024, 1)
block_kernel(const int32_t* __restrict__ block_first,
             const uint16_t* __restrict__ deltas,
             const uint16_t* __restrict__ valid_count,
             const uint32_t* __restrict__ bits,
             const uint32_t* __restrict__ edge_active,
             const float* __restrict__ block_weights,
             int NB, int n,
             const void* __restrict__ x, int B, long long x_stride,
             void* __restrict__ sums_out) {
  constexpr int FB = 32 * S;
  constexpr int W = FB / 32;              // mask words a block
  constexpr int L = FB == 128 ? 16 : 8;   // lanes a block
  constexpr int N = FB / L;               // consecutive slots a lane holds
  const int lane = threadIdx.x & 31;
  const int group = lane / L;
  const int sub = lane % L;
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (t >= (NB + T - 1) / T) return;  // uniform across the warp
  const int base = t * T;
  // lane k: block base + k's stored count and first target, one coalesced
  // load of each for the tile
  const bool mine = lane < T && base + lane < NB;
  const int count = mine ? static_cast<int>(__ldcs(valid_count + base + lane)) : 0;
  const int first = mine ? __ldcs(block_first + base + lane) : 0;
  const int j0 = sub * N;  // the lane's first slot
#pragma unroll 1
  for (int k0 = 0; k0 < T && base + k0 < NB; k0 += 32 / L) {
    const int i = base + k0 + group;
    const int cnt = __shfl_sync(kFull, count, k0 + group);
    const uint32_t start = static_cast<uint32_t>(__shfl_sync(kFull, first, k0 + group));
    const size_t row = static_cast<size_t>(i) * FB;
    // every load of the round first, then their uses
    uint32_t d[N];
    float w[N];
#pragma unroll
    for (int q = 0; q < N / S; ++q) {
      load_delta_chunk<S>(deltas + row, j0 + q * S, cnt, d + q * S);
      if (block_weights != nullptr) {
        load_weight_chunk<S>(block_weights + row, j0 + q * S, cnt, w + q * S);
      } else {
#pragma unroll
        for (int e = 0; e < S; ++e) w[q * S + e] = 1.0f;
      }
    }
    uint32_t word = kFull;
    if (j0 < cnt) {
      const size_t wi = static_cast<size_t>(i) * W + (j0 >> 5);
      if (bits != nullptr) word = __ldcs(bits + wi);
      if (edge_active != nullptr) word &= __ldcs(edge_active + wi);
    }
    // dst = first + inclusive prefix of the deltas, slot 0 zeroed: the lane's
    // own prefix, then a scan of the lane totals over the block's lanes, in
    // uint32 so it wraps like the reference's int32 cumsum
    if (sub == 0) d[0] = 0;
    uint32_t tot = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) { tot += d[j]; d[j] = tot; }
    uint32_t incl = tot;
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, off, L);
      if (sub >= off) incl += v;
    }
    const uint32_t at = start + (incl - tot);
    // -1: masked, x not read; a masked-in target >= n reads x[0], as the
    // reference's safe index does
    int32_t dst[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int32_t v = static_cast<int32_t>(at + d[j]);
      const bool m = j0 + j < cnt && ((word >> ((j0 + j) & 31)) & 1u);
      dst[j] = m ? (v < n ? v : 0) : -1;
    }
    for (int q0 = 0; q0 < B; q0 += QB) {
      using Acc = std::conditional_t<MODE == kSumsInt, uint32_t, float>;
      Acc acc[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        acc[u] = 0;
        if (QB > 1 && q0 + u >= B) continue;  // uniform across the warp
        const long long off = static_cast<long long>(q0 + u) * x_stride;
        if constexpr (MODE == kSumsInt) {
          const int32_t* xb = static_cast<const int32_t*>(x) + off;
          uint32_t xv[N];  // all gathers of the round in flight before the sum
#pragma unroll
          for (int j = 0; j < N; ++j) xv[j] = dst[j] >= 0 ? __ldg(xb + dst[j]) : 0;
#pragma unroll
          for (int j = 0; j < N; ++j) acc[u] += xv[j];
        } else {
          float xv[N];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            if constexpr (MODE == kSumsFloat) {
              xv[j] = dst[j] >= 0 ? __ldg(static_cast<const float*>(x) + off + dst[j]) : 0.0f;
            } else {
              xv[j] = dst[j] >= 0
                  ? static_cast<float>(__ldg(static_cast<const int32_t*>(x) + off + dst[j]))
                  : 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < N; ++j) acc[u] += dst[j] >= 0 ? xv[j] * w[j] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) acc[u] = group_sum<L>(acc[u]);
      if (sub == 0 && i < NB) {
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          if (QB == 1 || q0 + u < B) {
            const size_t o = static_cast<size_t>(i) * B + q0 + u;
            if constexpr (MODE == kSumsFloat) {
              static_cast<float*>(sums_out)[o] = acc[u];
            } else {
              static_cast<int32_t*>(sums_out)[o] = static_cast<int32_t>(acc[u]);
            }
          }
        }
      }
    }
  }
}

// ---- stream_round_kernel: one sparse_streamed round in one launch --------

constexpr int kRoundWarps = 8;
constexpr int kRoundTile = 8;                        // blocks a warp takes
constexpr int32_t kInfI32 = 0x7fffffff;              // min's identity over int32
constexpr int32_t kSatI32 = kInfI32 - (1 << 24);     // wBFS: saturate from here
enum RoundMap { kMapIdentity = 0, kMapSatAddI32 = 1 };

// wBFS's relaxation: x >= INF - 2^24 stays INF, else x + trunc(w), wrapping
// as int32 does.
__device__ __forceinline__ int32_t sat_add_i32(int32_t x, float w) {
  if (x >= kSatI32) return kInfI32;
  return static_cast<int32_t>(static_cast<uint32_t>(x) +
                              static_cast<uint32_t>(__float2int_rz(w)));
}

template <int S, int MAP>
__global__ void __launch_bounds__(32 * kRoundWarps)
stream_round_kernel(const int32_t* __restrict__ block_src,
                    const int32_t* __restrict__ block_first,
                    const uint16_t* __restrict__ deltas,
                    const uint16_t* __restrict__ valid_count,
                    const uint32_t* __restrict__ edge_active,
                    const float* __restrict__ block_weights,
                    const int32_t* __restrict__ exc_row,
                    const int32_t* __restrict__ exact_rows,
                    int NB, int n,
                    const uint8_t* __restrict__ frontier, long long f_stride,
                    const int32_t* __restrict__ x, long long x_stride,
                    const uint8_t* __restrict__ map_lanes, int B,
                    int32_t* __restrict__ out, uint8_t* __restrict__ touched) {
  constexpr int FB = 32 * S;
  constexpr int W = FB / 32;              // mask words a block
  constexpr int L = FB == 128 ? 16 : 8;   // lanes a block
  constexpr int G = 32 / L;               // blocks a warp decodes at once
  constexpr int N = FB / L;               // consecutive slots a lane holds
  const int lane = threadIdx.x & 31;
  const int group = lane / L;
  const int sub = lane % L;
  constexpr int T = kRoundTile;
  const int t = blockIdx.x * kRoundWarps + (threadIdx.x >> 5);
  if (t >= (NB + T - 1) / T) return;  // uniform across the warp
  const int base = t * T;
  // lane k < T: is block base + k live, i.e. does a query's frontier hold its owner
  const bool inb = lane < T && base + lane < NB;
  const int src = inb ? __ldg(block_src + base + lane) : 0;
  // owner n: a shard's pad block (valid count 0), never live, frontier not read
  const bool owned = inb && static_cast<uint32_t>(src) < static_cast<uint32_t>(n);
  bool any = false;
  for (int q = 0; owned && q < B && !any; ++q) any = frontier[q * f_stride + src] != 0;
  uint32_t live = __ballot_sync(kFull, any);
  if (live == 0) return;  // a dead tile reads no edge byte
  int count = 0, first = 0, er = -1;
  if (any) {
    count = __ldcs(valid_count + base + lane);
    first = __ldcs(block_first + base + lane);
    if (exc_row != nullptr) er = __ldg(exc_row + base + lane);
  }
  const int j0 = sub * N;  // the lane's first slot
#pragma unroll 1
  while (live != 0) {
    // the tile's G lowest live blocks, one to a group (k < 0: none left)
    int k = -1;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int pos = live != 0 ? __ffs(live) - 1 : -1;
      if (g == group) k = pos;
      live &= live - 1;
    }
    const int kk = k < 0 ? 0 : k;
    int cnt = __shfl_sync(kFull, count, kk);
    const uint32_t start = static_cast<uint32_t>(__shfl_sync(kFull, first, kk));
    int exc = __shfl_sync(kFull, er, kk);
    const int owner = __shfl_sync(kFull, src, kk);
    if (k < 0) { cnt = 0; exc = -1; }
    const int32_t x0 = __ldg(x + owner);  // query 0's value, in flight with the deltas
    const int i = base + kk;
    const size_t row = static_cast<size_t>(i) * FB;
    // every load of the round first, then their uses
    uint32_t d[N];
    float w[N];
    int32_t ex[N];
    const int dcnt = exc >= 0 ? 0 : cnt;  // an exception block reads no delta
#pragma unroll
    for (int q = 0; q < N / S; ++q) {
      load_delta_chunk<S>(deltas + row, j0 + q * S, dcnt, d + q * S);
      if (MAP == kMapSatAddI32 && block_weights != nullptr) {
        load_weight_chunk<S>(block_weights + row, j0 + q * S, cnt, w + q * S);
      } else {
#pragma unroll
        for (int e = 0; e < S; ++e) w[q * S + e] = 1.0f;
      }
    }
    if (exc >= 0) {
      const int4* er4 = reinterpret_cast<const int4*>(
          exact_rows + static_cast<size_t>(exc) * FB + j0);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int4 v = __ldg(er4 + q);
        ex[4 * q] = v.x; ex[4 * q + 1] = v.y; ex[4 * q + 2] = v.z; ex[4 * q + 3] = v.w;
      }
    }
    uint32_t word = kFull;
    if (edge_active != nullptr && j0 < dcnt) {
      word = __ldcs(edge_active + static_cast<size_t>(i) * W + (j0 >> 5));
    }
    // dst = first + inclusive prefix of the deltas, slot 0 zeroed, in uint32
    if (sub == 0) d[0] = 0;
    uint32_t tot = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) { tot += d[j]; d[j] = tot; }
    uint32_t incl = tot;
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, off, L);
      if (sub >= off) incl += v;
    }
    const uint32_t at = start + (incl - tot);
    // -1: the slot is masked out (past the count, inactive, or no target)
    int32_t dst[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (exc >= 0) {
        dst[j] = static_cast<uint32_t>(ex[j]) < static_cast<uint32_t>(n) ? ex[j] : -1;
      } else {
        const uint32_t v = at + d[j];
        const bool m = j0 + j < cnt && ((word >> ((j0 + j) & 31)) & 1u) &&
                       v < static_cast<uint32_t>(n);
        dst[j] = m ? static_cast<int32_t>(v) : -1;
      }
    }
    if (k < 0) continue;  // no shuffle below: groups part here
    for (int q = 0; q < B; ++q) {
      if (frontier[q * f_stride + owner] == 0) continue;  // uniform in the group
      const int32_t xv = q == 0 ? x0 : __ldg(x + q * x_stride + owner);
      const bool mapped = MAP == kMapSatAddI32 && (map_lanes == nullptr || map_lanes[q] != 0);
      // all of the slots' loads of out in flight before any atomic (a
      // block's targets are distinct); the atomics return nothing (RED)
      int32_t cur[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        cur[j] = dst[j] >= 0 ? out[static_cast<size_t>(dst[j]) * B + q] : 0;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (dst[j] < 0) continue;
        const int32_t v = mapped ? sat_add_i32(xv, w[j]) : xv;
        const size_t o = static_cast<size_t>(dst[j]) * B + q;
        if (cur[j] > v) {
          atomicMin(out + o, v);
          touched[o] = 1;
        } else if (v == kInfI32) {
          touched[o] = 1;
        }
      }
    }
  }
}

template <int S>
cudaError_t launch_chunked(int mode, int C, cudaStream_t stream, const int32_t* ids,
                           const int32_t* first, const uint16_t* deltas, const uint16_t* vc,
                           const uint32_t* bits, const uint32_t* active, const float* weights,
                           int NB, int n, const void* x, int B, long long x_stride,
                           int32_t* dst_out, float* w_out, void* sums_out) {
  const dim3 grid((C + kChunkWarps - 1) / kChunkWarps);
  const dim3 block(32 * kChunkWarps);
#define SAGE_LAUNCH(M)                                                                  \
  chunked_kernel<S, M><<<grid, block, 0, stream>>>(ids, C, first, deltas, vc, bits,     \
                                                    active, weights, NB, n, x, B,       \
                                                    x_stride, dst_out, w_out, sums_out)
  switch (mode) {
    case kDecode: SAGE_LAUNCH(kDecode); break;
    case kSumsFloat: SAGE_LAUNCH(kSumsFloat); break;
    case kSumsInt: SAGE_LAUNCH(kSumsInt); break;
    case kSumsIntWeighted: SAGE_LAUNCH(kSumsIntWeighted); break;
    default: return cudaErrorInvalidValue;
  }
#undef SAGE_LAUNCH
  return cudaGetLastError();
}

// A warp a tile of 32 blocks for one query; of 4 blocks for a batch, whose
// gathers make a warp's tile B times the work: at B = 8 on graph B, tiles
// of 32 left most of the card's warp slots empty and read slower than a
// warp a block; tiles of 4, two queries at a time, read the least of tiles
// of 4 and 8 at QB of 1, 2, 4 and 8.
template <int S>
cudaError_t launch_block(int mode, int warps, cudaStream_t stream, const int32_t* first,
                         const uint16_t* deltas, const uint16_t* vc, const uint32_t* bits,
                         const uint32_t* active, const float* weights, int NB, int n,
                         const void* x, int B, long long x_stride, void* sums_out) {
  const int tile = B == 1 ? 32 : 4;
  const long long tiles = (NB + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>((tiles + warps - 1) / warps));  // a warp a tile
  const dim3 block(32 * warps);
#define SAGE_LAUNCH(M)                                                                   \
  if (B == 1) {                                                                          \
    block_kernel<S, M, 1, 32><<<grid, block, 0, stream>>>(first, deltas, vc, bits,       \
                                                          active, weights, NB, n, x, B,  \
                                                          x_stride, sums_out);           \
  } else {                                                                               \
    block_kernel<S, M, 2, 4><<<grid, block, 0, stream>>>(first, deltas, vc, bits,        \
                                                         active, weights, NB, n, x, B,   \
                                                         x_stride, sums_out);            \
  }
  switch (mode) {
    case kSumsFloat: SAGE_LAUNCH(kSumsFloat); break;
    case kSumsInt: SAGE_LAUNCH(kSumsInt); break;
    case kSumsIntWeighted: SAGE_LAUNCH(kSumsIntWeighted); break;
    default: return cudaErrorInvalidValue;
  }
#undef SAGE_LAUNCH
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_round(int map, cudaStream_t stream, const int32_t* src, const int32_t* first,
                         const uint16_t* deltas, const uint16_t* vc, const uint32_t* active,
                         const float* weights, const int32_t* exc_row, const int32_t* exact,
                         int NB, int n, const uint8_t* frontier, long long f_stride,
                         const int32_t* x, long long x_stride, const uint8_t* map_lanes, int B,
                         int32_t* out, uint8_t* touched) {
  const long long tiles = (NB + kRoundTile - 1) / kRoundTile;
  const dim3 grid(static_cast<unsigned>((tiles + kRoundWarps - 1) / kRoundWarps));
  const dim3 block(32 * kRoundWarps);
#define SAGE_LAUNCH(M)                                                                   \
  stream_round_kernel<S, M><<<grid, block, 0, stream>>>(src, first, deltas, vc, active,  \
                                                        weights, exc_row, exact, NB, n,  \
                                                        frontier, f_stride, x, x_stride, \
                                                        map_lanes, B, out, touched)
  switch (map) {
    case kMapIdentity: SAGE_LAUNCH(kMapIdentity); break;
    case kMapSatAddI32: SAGE_LAUNCH(kMapSatAddI32); break;
    default: return cudaErrorInvalidValue;
  }
#undef SAGE_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// mode: 0 decode, 1 sums over float32 x, 2 sums over int32 x (unweighted),
// 3 sums over int32 x with weights.  Null pointers mark absent operands.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int compressed_chunked_spmv_launch(
    const int32_t* ids, int C, const int32_t* block_first, const uint16_t* deltas,
    const uint16_t* valid_count, const uint32_t* bits, const uint32_t* edge_active,
    const float* block_weights, int NB, int FB, int n, int mode, const void* x, int B,
    long long x_stride, int32_t* dst_out, float* w_out, void* sums_out, void* stream) {
  if (C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (FB) {
    case 32:
      return launch_chunked<1>(mode, C, s, ids, block_first, deltas, valid_count, bits,
                               edge_active, block_weights, NB, n, x, B, x_stride, dst_out,
                               w_out, sums_out);
    case 64:
      return launch_chunked<2>(mode, C, s, ids, block_first, deltas, valid_count, bits,
                               edge_active, block_weights, NB, n, x, B, x_stride, dst_out,
                               w_out, sums_out);
    case 128:
      return launch_chunked<4>(mode, C, s, ids, block_first, deltas, valid_count, bits,
                               edge_active, block_weights, NB, n, x, B, x_stride, dst_out,
                               w_out, sums_out);
    default:
      return cudaErrorInvalidValue;
  }
}

// Per-block sums over all NB blocks, `warps` warps per CTA (1..32), each a
// tile of 32 blocks.  mode as above, without decode.  Returns the cudaError_t of the launch.
extern "C" int compressed_block_spmv_launch(
    const int32_t* block_first, const uint16_t* deltas, const uint16_t* valid_count,
    const uint32_t* bits, const uint32_t* edge_active, const float* block_weights, int NB,
    int FB, int n, int mode, int warps, const void* x, int B, long long x_stride,
    void* sums_out, void* stream) {
  if (NB <= 0) return 0;
  if (warps < 1 || warps > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (FB) {
    case 32:
      return launch_block<1>(mode, warps, s, block_first, deltas, valid_count, bits,
                             edge_active, block_weights, NB, n, x, B, x_stride, sums_out);
    case 64:
      return launch_block<2>(mode, warps, s, block_first, deltas, valid_count, bits,
                             edge_active, block_weights, NB, n, x, B, x_stride, sums_out);
    case 128:
      return launch_block<4>(mode, warps, s, block_first, deltas, valid_count, bits,
                             edge_active, block_weights, NB, n, x, B, x_stride, sums_out);
    default:
      return cudaErrorInvalidValue;
  }
}

// One sparse_streamed round of min over int32: for every block whose owner a
// query's frontier holds (frontier: B rows of f_stride bytes), every
// masked-in slot's v = map(x[b, owner], w) is min-ed into out[dst * B + b]
// and touched[dst * B + b] set.  map: 0 identity, 1 saturating add of the
// truncated weight.  out (n, B) must hold INT32_MAX and touched (n, B) zeros
// on entry.  exc_row (NB,) names the row of exact_rows (int32, FB a row,
// 16-byte aligned) that replaces a block's decode, -1 for none; null when the
// graph has no exceptions.  map_lanes (B bytes) picks the queries the map
// applies to (null: all).  Null pointers mark absent operands.  Returns the
// cudaError_t of the launch.
extern "C" int compressed_stream_round_launch(
    const int32_t* block_src, const int32_t* block_first, const uint16_t* deltas,
    const uint16_t* valid_count, const uint32_t* edge_active, const float* block_weights,
    const int32_t* exc_row, const int32_t* exact_rows, int NB, int FB, int n, int map,
    const uint8_t* frontier, long long f_stride, const int32_t* x, long long x_stride,
    const uint8_t* map_lanes, int B, int32_t* out, uint8_t* touched, void* stream) {
  if (NB <= 0 || B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (FB) {
    case 32:
      return launch_round<1>(map, s, block_src, block_first, deltas, valid_count,
                             edge_active, block_weights, exc_row, exact_rows, NB, n,
                             frontier, f_stride, x, x_stride, map_lanes, B, out, touched);
    case 64:
      return launch_round<2>(map, s, block_src, block_first, deltas, valid_count,
                             edge_active, block_weights, exc_row, exact_rows, NB, n,
                             frontier, f_stride, x, x_stride, map_lanes, B, out, touched);
    case 128:
      return launch_round<4>(map, s, block_src, block_first, deltas, valid_count,
                             edge_active, block_weights, exc_row, exact_rows, NB, n,
                             frontier, f_stride, x, x_stride, map_lanes, B, out, touched);
    default:
      return cudaErrorInvalidValue;
  }
}
