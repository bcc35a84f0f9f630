// EmbeddingBag (gather + weighted bag sum) for Hopper (sm_90a).
//
// Replaces the TPU kernel embedding_bag_pallas
// (src/repro/kernels/embedding_bag/embedding_bag.py, body _kernel): for every
// bag b of a (B, L) id matrix,
//
//   out[b, :] = sum over slots s with 0 <= ids[b, s] < V of
//               w[b, s] * table[ids[b, s], :]
//
// in float32, rounded once to the table's dtype (float32 or bfloat16).  Any
// other id (negative padding, or >= V) is skipped: neither its row nor its
// weight is read into the sum.  `weights` may be NULL: every weight is 1.
// The weights come in the table's dtype (the wrapper casts them, as the JAX
// kernel does).  The table is the read-only large memory: never written.
//
// Bound on the H100: bandwidth.  A call must read the ids and weights once,
// one row of D elements for every valid slot, and write B rows: for SASRec's
// retrieval (1,000,448 bags of one over a 2^20 x 50 float32 catalog, no
// weights), 404 MB, 0.121 ms at 3.35 TB/s.  The arithmetic is one multiply-add an
// element read.
//
// Design (L > 1): one warp per bag, kBags (8) bags per CTA, no padding: the last CTA's
// surplus warps exit on a bounds check.  Lanes load up to 32 slots' ids and
// weights at once; a ballot of the valid slots is walked in slot order, and
// each valid slot's id and weight are broadcast with __shfl_sync, so padding
// costs no row read and the loop is uniform across the warp.  Lanes split a
// row into vectors of VB bytes (16, 8, 4 or one element, chosen by the
// wrapper from D * elt and the pointers' alignment: SASRec's 200-byte
// float32 rows take 8 B, its 100-byte bfloat16 rows 4 B), one vector a lane,
// 32 vectors a column tile.  Up to four rows are loaded before they are
// added, to keep more bytes in flight.  The products and the sum use
// __fmul_rn and __fadd_rn (no fused multiply-add) in slot order, the plain
// version's arithmetic, so a bag of one with weight 1 is its row exactly.
// Row offsets are 64-bit.  The TPU's VMEM-resident table and its padding of
// the batch to a tile are not carried over.
// Design (L = 1, every take_rows call): a warp per bag would move one
// 200-byte row behind a dependent id load, 7 lanes idle, and reached 52 % of
// the bound.  So a warp takes 32 bags: its lanes load the 32 ids (and
// weights) in one coalesced load each, then stream the 32 rows as one flat
// run of 32 * D*elt/VB vectors.  Flat vector f is column f % nvec of bag
// f / nvec, whose id and weight come by __shfl_sync from lane f / nvec; the
// 32 output rows are contiguous, so vector f is stored at out + f.  A lane
// loads kAheadOne vectors (32 B at VB = 16 and 8; 16 B and 8 B at the
// narrower widths) before it stores them, held as raw words: ~1 KB a warp
// in flight, against one 200-byte row before.  Each element is still
// __fadd_rn(0, __fmul_rn(v, w)), the plain version's arithmetic (it turns a
// -0.0 element into +0.0), not a copy.  Bags past B and ids outside [0, V)
// give zero rows; no row or weight of theirs is read.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAhead = 4;  // rows loaded before they are added
constexpr int kBags = 8;   // bags per CTA, a warp each
// CTAs an SM must hold at once: 64 warps, the most an SM takes, which caps a
// thread at 32 registers.  The kernel is latency-bound, so its time follows
// the warps an SM holds: on an H100 SXM (700 W), retrieval's shape took
// 0.230 ms so, and 0.277 ms or 0.318 ms when the compiler, uncapped, took
// registers enough to fit fewer warps.  The cap may cost the 16-byte builds
// a few spilled words (chip_smoke.py prints ptxas's report).
constexpr int kMinCtas = 2048 / (32 * kBags);

template <int VB>
__device__ __forceinline__ void load_words(const void* p, unsigned (&w)[VB / 4]) {
  if constexpr (VB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

template <int VB>
__device__ __forceinline__ void store_words(void* p, const unsigned (&w)[VB / 4]) {
  if constexpr (VB == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned*>(p) = w[0];
  }
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// One vector of VB bytes of a row as float32 values (bfloat16 widens exactly).
template <typename T, int VB>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VB / sizeof(T)]) {
  if constexpr (VB == 2) {
    f[0] = __uint_as_float(static_cast<unsigned>(
               __ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  } else {
    unsigned w[VB / 4];
    load_words<VB>(p, w);
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        f[i] = __uint_as_float(w[i]);
      } else {  // little-endian: the low half is the first element
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int VB>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VB / sizeof(T)]) {
  if constexpr (VB == 2) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(bf16_bits(f[0]));
  } else {
    unsigned w[VB / 4];
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        w[i] = __float_as_uint(f[i]);
      } else {
        w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
      }
    }
    store_words<VB>(p, w);
  }
}

// One vector of VB bytes kept as raw words (a 2-byte one in the low half),
// and those words as float32 values: a bfloat16 vector waits in half the
// registers its values take.
template <int VB>
__device__ __forceinline__ void load_raw(const void* p, unsigned (&w)[(VB + 3) / 4]) {
  if constexpr (VB == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    load_words<VB>(p, w);
  }
}

template <typename T, int VB>
__device__ __forceinline__ void unpack(const unsigned (&w)[(VB + 3) / 4],
                                       float (&f)[VB / sizeof(T)]) {
  if constexpr (VB == 2) {
    f[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        f[i] = __uint_as_float(w[i]);
      } else {  // little-endian: the low half is the first element
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ float weight_of(const T* w) {
  if constexpr (std::is_same_v<T, float>) {
    return __ldg(w);
  } else {
    return __uint_as_float(static_cast<unsigned>(
               __ldg(reinterpret_cast<const unsigned short*>(w))) << 16);
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(32 * kBags, kMinCtas)
embedding_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                     const T* __restrict__ weights, int V, int D, int B, int L,
                     T* __restrict__ out) {
  constexpr int N = VB / sizeof(T);  // elements a lane loads at once
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kBags + (threadIdx.x >> 5);
  if (bag >= B) return;  // uniform across the warp
  const int nvec = D / N;
  const int32_t* bag_ids = ids + static_cast<int64_t>(bag) * L;
  const T* bag_w = weights == nullptr ? nullptr : weights + static_cast<int64_t>(bag) * L;
  T* orow = out + static_cast<int64_t>(bag) * D;

  for (int c0 = 0; c0 < nvec; c0 += 32) {  // column tiles of 32 vectors
    const int col = (c0 + lane) * N;
    const bool active = c0 + lane < nvec;
    float acc[N];
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
    for (int s0 = 0; s0 < L; s0 += 32) {
      int my_id = -1;
      float my_w = 1.f;
      if (s0 + lane < L) {
        my_id = __ldg(bag_ids + s0 + lane);
        if (bag_w != nullptr) my_w = weight_of<T>(bag_w + s0 + lane);
      }
      unsigned todo = __ballot_sync(kFull, my_id >= 0 && my_id < V);
      while (todo != 0u) {  // the valid slots in order, kAhead at a time
        float row[kAhead][N];
        float wt[kAhead];
        bool have[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          have[u] = todo != 0u;
          const int src = have[u] ? __ffs(todo) - 1 : 0;
          todo &= todo - 1u;
          const int id = __shfl_sync(kFull, my_id, src);
          wt[u] = __shfl_sync(kFull, my_w, src);
          if (have[u] && active) {
            load_vec<T, VB>(table + static_cast<int64_t>(id) * D + col, row[u]);
          } else {
#pragma unroll
            for (int e = 0; e < N; ++e) row[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (have[u]) {
#pragma unroll
            for (int e = 0; e < N; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(row[u][e], wt[u]));
          }
        }
      }
    }
    if (active) store_vec<T, VB>(orow + col, acc);
  }
}

// Bags of one (L = 1): a warp takes 32 consecutive bags; see the note above.
template <typename T, int VB>
__global__ void __launch_bounds__(32 * kBags, kMinCtas)
bags_of_one_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                   const T* __restrict__ weights, int V, int D, int B,
                   T* __restrict__ out) {
  constexpr int N = VB / sizeof(T);                     // elements a vector
  constexpr int kAheadOne = VB >= 8 ? 32 / VB : 4;      // vectors loaded before stored
  constexpr int kWords = (VB + 3) / 4;
  const int lane = threadIdx.x & 31;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kBags + (threadIdx.x >> 5)) * 32;
  if (first >= B) return;  // uniform across the warp
  const int rows = B - first < 32 ? static_cast<int>(B - first) : 32;  // bags of this warp
  int my_id = -1;
  float my_w = 1.f;
  if (lane < rows) {
    my_id = __ldg(ids + first + lane);
    if (weights != nullptr) my_w = weight_of<T>(weights + first + lane);
  }
  if (my_id >= V) my_id = -1;
  const bool weighted = weights != nullptr;
  const int nvec = D / N;            // vectors a row
  const int total = rows * nvec;     // vectors the warp stores
  const int step_bag = 32 / nvec, step_col = 32 % nvec;  // (bag, column) of f += 32
  int bag = lane / nvec, col = lane % nvec;
  T* obase = out + first * D;
  for (int c0 = 0; c0 < nvec; c0 += kAheadOne) {  // a lane's vectors: f = lane + 32 c
    unsigned raw[kAheadOne][kWords];
    float wt[kAheadOne];
#pragma unroll
    for (int u = 0; u < kAheadOne; ++u) {
      const int f = lane + 32 * (c0 + u);
      const int id = __shfl_sync(kFull, my_id, bag & 31);
      wt[u] = weighted ? __shfl_sync(kFull, my_w, bag & 31) : 1.f;
      if (f < total && id >= 0) {
        load_raw<VB>(table + static_cast<int64_t>(id) * D + col * N, raw[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kWords; ++e) raw[u][e] = 0u;
        wt[u] = 1.f;  // a zero row: 0 * 1, never a padding weight
      }
      bag += step_bag;
      col += step_col;
      if (col >= nvec) {
        col -= nvec;
        ++bag;
      }
    }
#pragma unroll
    for (int u = 0; u < kAheadOne; ++u) {
      const int f = lane + 32 * (c0 + u);
      if (f < total) {
        float v[N];
        unpack<T, VB>(raw[u], v);
#pragma unroll
        for (int e = 0; e < N; ++e) v[e] = __fadd_rn(0.f, __fmul_rn(v[e], wt[u]));
        store_vec<T, VB>(obase + static_cast<int64_t>(f) * N, v);
      }
    }
  }
}

template <typename T, int VB>
cudaError_t launch(const void* table, const int32_t* ids, const void* weights, int V, int D,
                   int B, int L, void* out, cudaStream_t stream) {
  const dim3 block(32 * kBags);
  if (L == 1) {
    const dim3 grid(static_cast<unsigned>((B + 32LL * kBags - 1) / (32LL * kBags)));
    bags_of_one_kernel<T, VB><<<grid, block, 0, stream>>>(
        static_cast<const T*>(table), ids, static_cast<const T*>(weights), V, D, B,
        static_cast<T*>(out));
  } else {
    const dim3 grid((B + kBags - 1) / kBags);
    embedding_bag_kernel<T, VB><<<grid, block, 0, stream>>>(
        static_cast<const T*>(table), ids, static_cast<const T*>(weights), V, D, B, L,
        static_cast<T*>(out));
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vb(int vec_bytes, const void* table, const int32_t* ids,
                      const void* weights, int V, int D, int B, int L, void* out,
                      cudaStream_t stream) {
  switch (vec_bytes) {
    case 16:
      return launch<T, 16>(table, ids, weights, V, D, B, L, out, stream);
    case 8:
      return launch<T, 8>(table, ids, weights, V, D, B, L, out, stream);
    case 4:
      return launch<T, 4>(table, ids, weights, V, D, B, L, out, stream);
    case 2:  // one bfloat16 element; a float32 element is 4 bytes
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        return launch<T, 2>(table, ids, weights, V, D, B, L, out, stream);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward (kernel 5'): the gradient of the bag sums with respect to a float32
// table.  It replaces no TPU kernel: the JAX package differentiates jnp.take,
// a scatter-add.  For every slot (b, s) with 0 <= id < V,
//
//   grad_table[id, :] += w[b, s] * grad_out[b, :]     (w = 1 without weights)
//
// in float32; padding and out-of-range ids add nothing, and a row no id
// touches is written as exact zeros.  Every row is written once.
//
// Deterministic, with no float atomics: the wrapper sorts the slots by id
// (a stable sort, so a row's slots stay in slot order) and gives each row's
// range of the sorted slots (row_start) and the numbering of its chunks
// (chunk_base).  A row of at most `chunk` slots is summed by one warp, slot by
// slot from 0.  A longer row (SASRec's padding item 0 takes ~24 % of a
// train_batch lookup's 3,276,800 slots) is cut into chunks of `chunk` slots
// from its first: one warp a chunk sums its slots in order into a float32
// partial (bag_grad_chunks_kernel), then the row's warp sums its partials in
// order from 0 (bag_grad_rows_kernel).  The plain version
// embedding_bag_backward_ref (ref.py) repeats that association, so the two
// agree bit for bit; a short row's sum is 0 + its one partial, which is the
// partial itself (a sum from +0.0 is never -0.0).
//
// Bound on the H100: bandwidth.  A call must read the gradient rows, the
// ids (and weights) once and write the (V, D) table once: at train_batch's
// lookup (3,276,800 ids, a 2^20 x 50 table) 878.2 MB, 0.262 ms at 3.35 TB/s.
// Lanes hold 32 columns of C tiles (D = 50: two floats a lane), load a
// slot's id and weight 32 at a time and broadcast them with __shfl_sync, and
// load kBwdAhead rows before adding them in order.  __fmul_rn / __fadd_rn:
// no fused multiply-add, the plain version's arithmetic.
constexpr int kBwdAhead = 8;  // gradient rows (or partials) loaded before they are added

template <int C>
__device__ __forceinline__ void fold_slots(const float* __restrict__ grad,
                                           const int32_t* __restrict__ order,
                                           const float* __restrict__ weights, int L, int D,
                                           int col0, int64_t p0, int64_t p1, float (&acc)[C]) {
  const int lane = threadIdx.x & 31;
  for (int64_t base = p0; base < p1; base += 32) {
    const int n = p1 - base < 32 ? static_cast<int>(p1 - base) : 32;
    int my_slot = 0;
    float my_w = 1.f;
    if (lane < n) {
      my_slot = __ldg(order + base + lane);
      if (weights != nullptr) my_w = __ldg(weights + my_slot);
    }
    for (int u0 = 0; u0 < n; u0 += kBwdAhead) {  // uniform across the warp
      float row[kBwdAhead][C];
      float wt[kBwdAhead];
#pragma unroll
      for (int u = 0; u < kBwdAhead; ++u) {
        const int src = u0 + u;
        const int slot = __shfl_sync(kFull, my_slot, src & 31);
        wt[u] = __shfl_sync(kFull, my_w, src & 31);
        const float* g = grad + static_cast<int64_t>(slot / L) * D;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = col0 + lane + 32 * c;
          row[u][c] = (src < n && col < D) ? __ldg(g + col) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdAhead; ++u) {
        if (u0 + u < n) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[c] = __fadd_rn(acc[c], weights != nullptr ? __fmul_rn(row[u][c], wt[u])
                                                          : row[u][c]);
          }
        }
      }
    }
  }
}

// One warp a chunk of a long row: its slots summed in order into partials.
template <int C>
__global__ void __launch_bounds__(32 * kBags)
bag_grad_chunks_kernel(const float* __restrict__ grad, const int32_t* __restrict__ order,
                       const float* __restrict__ weights, const int32_t* __restrict__ row_start,
                       const int32_t* __restrict__ chunk_base, int V, int D, int L, int chunk,
                       float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kBags + (threadIdx.x >> 5);
  if (w >= __ldg(chunk_base + V)) return;  // uniform across the warp
  int lo = 0, hi = V;  // chunk_base[lo] <= w < chunk_base[hi]: the row that owns chunk w
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(chunk_base + mid) <= w) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int64_t p0 = __ldg(row_start + lo) + (w - __ldg(chunk_base + lo)) * chunk;
  const int64_t end = __ldg(row_start + lo + 1);
  const int64_t p1 = p0 + chunk < end ? p0 + chunk : end;
  for (int col0 = 0; col0 < D; col0 += 32 * C) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    fold_slots<C>(grad, order, weights, L, D, col0, p0, p1, acc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = col0 + lane + 32 * c;
      if (col < D) partials[w * D + col] = acc[c];
    }
  }
}

// One warp a row of the table: its slots (a short row) or its chunks'
// partials (a long row) summed in order from 0; zeros for an untouched row.
template <int C>
__global__ void __launch_bounds__(32 * kBags)
bag_grad_rows_kernel(const float* __restrict__ grad, const int32_t* __restrict__ order,
                     const float* __restrict__ weights, const int32_t* __restrict__ row_start,
                     const int32_t* __restrict__ chunk_base,
                     const float* __restrict__ partials, int V, int D, int L,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kBags + (threadIdx.x >> 5);
  if (v >= V) return;  // uniform across the warp
  const int64_t p0 = __ldg(row_start + v), p1 = __ldg(row_start + v + 1);
  const int c0 = __ldg(chunk_base + v), c1 = __ldg(chunk_base + v + 1);
  for (int col0 = 0; col0 < D; col0 += 32 * C) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    if (c1 > c0) {
      for (int j0 = c0; j0 < c1; j0 += kBwdAhead) {  // uniform across the warp
        float part[kBwdAhead][C];
#pragma unroll
        for (int u = 0; u < kBwdAhead; ++u) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int col = col0 + lane + 32 * c;
            part[u][c] = (j0 + u < c1 && col < D)
                             ? __ldg(partials + static_cast<int64_t>(j0 + u) * D + col) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBwdAhead; ++u) {
          if (j0 + u < c1) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], part[u][c]);
          }
        }
      }
    } else {
      fold_slots<C>(grad, order, weights, L, D, col0, p0, p1, acc);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = col0 + lane + 32 * c;
      if (col < D) out[v * D + col] = acc[c];
    }
  }
}

template <int C>
cudaError_t launch_backward(const float* grad, const int32_t* order, const float* weights,
                            const int32_t* row_start, const int32_t* chunk_base,
                            float* partials, int max_chunks, int V, int D, int L, int chunk,
                            float* out, cudaStream_t stream) {
  const dim3 block(32 * kBags);
  if (max_chunks > 0) {
    const dim3 grid((max_chunks + kBags - 1) / kBags);
    bag_grad_chunks_kernel<C><<<grid, block, 0, stream>>>(grad, order, weights, row_start,
                                                         chunk_base, V, D, L, chunk, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((V + kBags - 1) / kBags);
  bag_grad_rows_kernel<C><<<grid, block, 0, stream>>>(grad, order, weights, row_start,
                                                     chunk_base, partials, V, D, L, out);
  return cudaGetLastError();
}

}  // namespace

// table (V, D) of dtype 0 (float32) or 1 (bfloat16); ids (B, L) int32;
// weights (B, L) of the table's dtype, or NULL for weights of 1; writes out
// (B, D) of the table's dtype.  `vec_bytes` (16, 8, 4, or 2 for bfloat16)
// must divide D * elt and the table's and the output's addresses.  Returns the cudaError_t of the launch (0 on success).
extern "C" int embedding_bag_launch(const void* table, const int32_t* ids, const void* weights,
                                    int V, int D, int B, int L, int dtype, int vec_bytes,
                                    void* out, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (V < 0 || L < 0) return cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  if (vec_bytes < elt || (D * elt) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(table) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % vec_bytes != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_vb<float>(vec_bytes, table, ids, weights, V, D, B, L, out, s);
    case 1:
      return launch_vb<__nv_bfloat16>(vec_bytes, table, ids, weights, V, D, B, L, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Kernel 5': grad (B, D) float32, order (B * L) int32 and row_start,
// chunk_base (V + 1) int32 from the wrapper's stable sort of the ids (see
// above), weights (B * L) float32 or NULL; partials is scratch of at least
// max_chunks x D floats, max_chunks >= chunk_base[V].  Writes out (V, D)
// float32, every row.  Launches the chunk pass, then the row pass, on
// `stream`; returns the first cudaError_t (0 on success).
extern "C" int embedding_bag_backward_launch(const float* grad, const int32_t* order,
                                             const float* weights, const int32_t* row_start,
                                             const int32_t* chunk_base, float* partials,
                                             int max_chunks, int V, int D, int L, int chunk,
                                             float* out, void* stream) {
  if (V <= 0 || D <= 0) return 0;
  if (L <= 0 || chunk <= 0 || max_chunks < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {  // column tiles of 32 a lane holds: 4 at most, then tiles again
    case 1:
      return launch_backward<1>(grad, order, weights, row_start, chunk_base, partials,
                                max_chunks, V, D, L, chunk, out, s);
    case 2:
      return launch_backward<2>(grad, order, weights, row_start, chunk_base, partials,
                                max_chunks, V, D, L, chunk, out, s);
    case 3:
      return launch_backward<3>(grad, order, weights, row_start, chunk_base, partials,
                                max_chunks, V, D, L, chunk, out, s);
    default:
      return launch_backward<4>(grad, order, weights, row_start, chunk_base, partials,
                                max_chunks, V, D, L, chunk, out, s);
  }
}
