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
// a scatter-add, and has no backward kernel.  For every slot (b, s) with
// 0 <= id < V,
//
//   grad_table[id, :] += w[b, s] * grad_out[b, :]     (w = 1 without weights)
//
// in float32; padding and out-of-range ids add nothing, and a row no id
// touches is written as exact zeros.  Every row is written once.
//
// Deterministic, with no float atomics: the preparation (bag_plan.cu, the
// port's own stable radix sort) groups the slots by id, a row's slots in slot
// order (order, row_start), and numbers the chunks of the long rows
// (chunk_base).  A row of at most `chunk` slots is summed slot by slot from
// 0.  A longer row is cut into chunks of `chunk` slots from its first: each
// chunk is summed in order into a float32 partial, and the row is the sum of
// its partials in order from 0.  The plain version embedding_bag_backward_ref
// (ref.py) repeats that association, so the two agree bit for bit; a short
// row's sum is 0 + its one partial, which is the partial itself (a sum from
// +0.0 is never -0.0).  __fmul_rn / __fadd_rn: no fused multiply-add.
//
// Bound on the H100: bandwidth.  A call must read the gradient rows, the
// ids (and weights) once and write the (V, D) table once: at train_batch's
// lookup (3,276,800 ids, a 2^20 x 50 table) 878.2 MB, 0.262 ms at 3.35 TB/s.
//
// Design.  The first design (one warp a row, behind torch.sort) reached
// 16 % of that bound, held back by three things; each is answered here.
// 1. The preparation, a dozen torch launches (a stable sort over all 32
//    bits with int64 indices, the padding sorted along, searchsorted's ~22
//    dependent probes a row): now the port's own radix sort (bag_plan.cu),
//    over the bits V - 1 needs, the padding dropped, row_start written by a
//    boundary pass and chunk_base by a scan.
// 2. The row pass, one warp a row: a chain of dependent loads (row_start,
//    order, then ~625 B of rows) and 14 of 64 lane columns idle at D = 50.
//    Now a block takes a tile of consecutive rows (bag_grad_rows_kernel):
//    it loads the tile's row_start once and its rows' slot ids (and
//    weights) coalesced into shared memory; cp.async copies all of a
//    batch's gradient rows into a shared stage at once (no register holds
//    them in flight); its threads take the tile's output as one flat run
//    of vectors of VW floats (VW = 4, 2 or 1: the widest that divides D and
//    the addresses; 8 bytes at D = 50), kTileElems a thread, so that no
//    lane idles on a row's width, and add each vector's row from the stage
//    in slot order.  The tile's output rows are contiguous and are stored
//    as one coalesced run, untouched rows as zeros in the same stores.  A
//    tile's life is three dependent round trips (row_start, slot ids,
//    gradient rows), so the pass is quickest with the most tiles in
//    flight: one warp a block, 32 blocks an SM, 5 rows a tile at D = 50.
// 3. The hot row (SASRec's padding item 0, ~24 % of a lookup: 768 chunks),
//    walked 8 rows at a time by one warp a chunk and its 768 partials by
//    one warp.  Now one block a chunk (bag_grad_chunks_kernel) stages the
//    chunk's slot ids in shared memory and streams its gradient rows
//    through a two-stage shared-memory ring filled by cp.async (kStage
//    floats a stage: 71 rows at D = 50), the next stage in flight while a
//    thread a column adds the current one in order; one warp finds the
//    chunk's row in 32-ary steps.  One block a long row
//    (bag_grad_combine_kernel) streams the row's partials through a ring of
//    96 KB stages (768 partials of 200 B in two) and adds them in order, a
//    thread a column.  No chain of dependent global round trips is longer
//    than a ring's count of stages.
// Rows of 200 B are 8-byte aligned and only every other one is 16-byte
// aligned; TMA needs inner extents of multiples of 16 B, so the stages are
// filled by cp.async of VW * 4 bytes instead.  Any D works: a block takes
// its columns in slices of kSliceCols floats (rings) or of at most
// kRowThreads * kTileElems vectors (rows).
constexpr int kCombineThreads = 256;  // threads a block of the combine
constexpr int kRowThreads = 32;       // threads a block of the row pass: one warp
constexpr int kTileElems = 4;         // output vectors a thread of the row pass holds
constexpr int kMaxTileRows = kRowThreads;  // rows a tile of the row pass takes, at most: a lane's
static_assert(kRowThreads == 32, "a tile's rows are numbered by one warp scan");
constexpr int kRowSlots = 64;         // slots a batch of the row pass takes, at most
constexpr int kRowStage = 1024;       // floats of gradient rows a row-pass batch stages
constexpr int kChunkThreads = 128;    // threads a block of the chunk pass
constexpr int kChunk = 1024;          // slots a chunk of a long row (BACKWARD_CHUNK), staged
constexpr int kStage = 3584;          // floats a ring stage of the chunk pass holds
constexpr int kCombineStage = 24576;  // floats a ring stage of the combine holds (96 KB)
constexpr int kSliceCols = 1024;      // columns a ring's block sums at once
constexpr int kChunkBlocks = 1024;    // blocks of the chunk pass, at most: they stride
constexpr int kCombineBlocks = 132;   // blocks of the combine, at most: one an SM

// Exclusive prefix sum of one int a lane across the warp (lane order); the
// warp's sum in *total.  Every lane must call it.
__device__ __forceinline__ int warp_exclusive_sum(int x, int* total) {
  const int lane = threadIdx.x & 31;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  *total = __shfl_sync(kFull, incl, 31);
  return incl - x;
}

template <int VW>
__device__ __forceinline__ void store_floats(float* p, const float (&x)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct SlotRows {  // a ring's k-th row: gradient row srow[k] (shared memory)
  const int* srow;
  __device__ int64_t operator()(int k) const { return srow[k]; }
};

struct RunRows {   // a ring's k-th row: row first + k (the partials of a long row)
  int64_t first;
  __device__ int64_t operator()(int k) const { return first + k; }
};

// Rows r0 .. r0 + nr - 1 of a ring's list, columns [c0, c0 + ds), copied into
// the stage `buf` as one commit group.
template <int VW, int T, typename Rows>
__device__ __forceinline__ void ring_fill(const float* __restrict__ src, int64_t D, int c0, int ds,
                                          Rows rows, int r0, int nr, float* buf) {
  const int nvec = ds / VW;
  for (int f = threadIdx.x; f < nr * nvec; f += T) {
    const int r = f / nvec, c = f - r * nvec;
    cp_async<4 * VW>(buf + r * ds + c * VW, src + rows(r0 + r) * D + c0 + c * VW);
  }
  cp_async_commit();
}

// Adds rows(0), ..., rows(n - 1) of src (rows of D floats), columns [c0, c0 +
// ds), in that order into acc, times sw[k] (shared memory) unless sw is NULL:
// thread t of the block's T holds column c0 + t + T * j in acc[j].  The rows
// pass through `ring`, two stages of `stage` floats, the next in flight while
// the block adds the current one.  Every thread of the block calls it.
template <int VW, int T, typename Rows>
__device__ void ring_sum(const float* __restrict__ src, int64_t D, int c0, int ds, int n, Rows rows,
                         const float* sw, float* ring, int stage, float (&acc)[kSliceCols / T]) {
  const int per = stage / ds;  // rows a stage holds
  const int batches = (n + per - 1) / per;
  if (batches > 0) ring_fill<VW, T>(src, D, c0, ds, rows, 0, min(per, n), ring);
  for (int q = 0; q < batches; ++q) {
    const int r0 = q * per, nr = min(per, n - r0);
    if (q + 1 < batches) {
      ring_fill<VW, T>(src, D, c0, ds, rows, r0 + per, min(per, n - r0 - per),
                       ring + ((q + 1) & 1) * stage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = ring + (q & 1) * stage;
#pragma unroll
    for (int j = 0; j < kSliceCols / T; ++j) {
      const int c = threadIdx.x + j * T;
      if (c < ds) {
        float a = acc[j];
        for (int r = 0; r < nr; ++r) {
          const float x = buf[r * ds + c];
          a = __fadd_rn(a, sw != nullptr ? __fmul_rn(x, sw[r0 + r]) : x);
        }
        acc[j] = a;
      }
    }
    __syncthreads();  // the stage is free to be filled again
  }
}

// The row that owns chunk w: chunk_base[v] <= w < chunk_base[v + 1], by one
// warp in 32-ary steps (4 dependent loads at V = 2^20, not 20).  Every lane
// of the warp calls it and gets the row.
__device__ int chunk_owner(const int32_t* __restrict__ chunk_base, int V, int w) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = V;  // chunk_base[lo] <= w < chunk_base[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + (lane + 1) * step;  // lane 31's lies at or past hi
    const bool le = probe < hi && __ldg(chunk_base + probe) <= w;
    const int k = __popc(__ballot_sync(kFull, le));  // the probes <= w: a prefix of lanes
    const int next = lo + (k + 1) * step;
    lo += k * step;
    hi = next < hi ? next : hi;
  }
  return lo;
}

// One block a chunk of a long row at a time (blocks stride over the
// chunks): the chunk's slots' rows summed in order into partials[w];
// chunk_row[w] is the row for a row's first chunk, -1 for the others.
template <int VW>
__global__ void __launch_bounds__(kChunkThreads)
bag_grad_chunks_kernel(const float* __restrict__ grad, const int32_t* __restrict__ order,
                       const float* __restrict__ weights, const int32_t* __restrict__ row_start,
                       const int32_t* __restrict__ chunk_base, int V, int D, int L, int chunk,
                       float* __restrict__ partials, int32_t* __restrict__ chunk_row) {
  __shared__ __align__(16) float ring[2 * kStage];
  __shared__ int srow[kChunk];
  __shared__ float sw[kChunk];
  __shared__ int owner;
  const int total = __ldg(chunk_base + V);
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    if (threadIdx.x < 32) {
      const int v = chunk_owner(chunk_base, V, w);
      if (threadIdx.x == 0) owner = v;
    }
    __syncthreads();
    const int v = owner;
    const int first = __ldg(chunk_base + v);
    const int p0 = __ldg(row_start + v) + (w - first) * chunk;
    const int left = __ldg(row_start + v + 1) - p0;
    const int n = left < chunk ? left : chunk;
    for (int k = threadIdx.x; k < n; k += kChunkThreads) {
      const int slot = __ldg(order + p0 + k);
      srow[k] = slot / L;
      if (weights != nullptr) sw[k] = __ldg(weights + slot);
    }
    if (threadIdx.x == 0) chunk_row[w] = w == first ? v : -1;
    __syncthreads();
    for (int c0 = 0; c0 < D; c0 += kSliceCols) {
      const int ds = D - c0 < kSliceCols ? D - c0 : kSliceCols;
      float acc[kSliceCols / kChunkThreads];
#pragma unroll
      for (int j = 0; j < kSliceCols / kChunkThreads; ++j) acc[j] = 0.f;
      ring_sum<VW, kChunkThreads>(grad, D, c0, ds, n, SlotRows{srow},
                                weights != nullptr ? sw : nullptr, ring, kStage, acc);
#pragma unroll
      for (int j = 0; j < kSliceCols / kChunkThreads; ++j) {
        const int c = threadIdx.x + j * kChunkThreads;
        if (c < ds) partials[static_cast<int64_t>(w) * D + c0 + c] = acc[j];
      }
    }
    __syncthreads();  // owner and the slot ids are free for the next chunk
  }
}

// One block a long row, at its first chunk (blocks stride over the chunks):
// the row's partials summed in order from 0 into its output row.
template <int VW>
__global__ void __launch_bounds__(kCombineThreads)
bag_grad_combine_kernel(const float* __restrict__ partials, const int32_t* __restrict__ chunk_base,
                        const int32_t* __restrict__ chunk_row, int V, int D,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float combine_ring[];  // two stages of kCombineStage floats
  const int total = __ldg(chunk_base + V);
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    const int v = __ldg(chunk_row + w);
    if (v < 0) continue;  // not a row's first chunk; uniform across the block
    const int n = __ldg(chunk_base + v + 1) - w;
    for (int c0 = 0; c0 < D; c0 += kSliceCols) {
      const int ds = D - c0 < kSliceCols ? D - c0 : kSliceCols;
      float acc[kSliceCols / kCombineThreads];
#pragma unroll
      for (int j = 0; j < kSliceCols / kCombineThreads; ++j) acc[j] = 0.f;
      ring_sum<VW, kCombineThreads>(partials, D, c0, ds, n, RunRows{w}, nullptr, combine_ring,
                            kCombineStage, acc);
#pragma unroll
      for (int j = 0; j < kSliceCols / kCombineThreads; ++j) {
        const int c = threadIdx.x + j * kCombineThreads;
        if (c < ds) out[static_cast<int64_t>(v) * D + c0 + c] = acc[j];
      }
    }
  }
}

// One block a tile of `tile_rows` consecutive rows: every row of at most
// `chunk` slots (zeros for an untouched one), its slots in order from 0; the
// long rows are left to the combine.  A row is taken `slice` vectors of VW
// floats at a time; a batch of the tile's slots has its gradient rows (that
// slice of them) copied into shared memory by cp.async, all in flight at
// once, and then summed from there (see the note above).
template <int VW, bool kWeighted>
__global__ void __launch_bounds__(kRowThreads)
bag_grad_rows_kernel(const float* __restrict__ grad, const int32_t* __restrict__ order,
                     const float* __restrict__ weights, const int32_t* __restrict__ row_start,
                     int V, int D, int L, int chunk, int tile_rows, int slice,
                     float* __restrict__ out) {
  __shared__ __align__(16) float stage[kRowStage];
  __shared__ int rs[kMaxTileRows + 1];  // the tile's row_start
  __shared__ int vs[kMaxTileRows + 1];  // each row's first slot among the tile's short rows'
  __shared__ int srow[kRowSlots];
  __shared__ float sw[kRowSlots];
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int nr = V - v0 < tile_rows ? static_cast<int>(V - v0) : tile_rows;
  for (int j = threadIdx.x; j <= nr; j += kRowThreads) rs[j] = __ldg(row_start + v0 + j);
  __syncthreads();
  int len = 0;
  if (threadIdx.x < nr) {
    len = rs[threadIdx.x + 1] - rs[threadIdx.x];
    if (len > chunk) len = 0;  // a long row: the chunk pass and the combine write it
  }
  int S;
  const int start = warp_exclusive_sum(len, &S);
  if (threadIdx.x < nr) vs[threadIdx.x] = start;
  if (threadIdx.x == 0) vs[nr] = S;
  __syncthreads();
  const int nvec = D / VW;
  for (int c0 = 0; c0 < nvec; c0 += slice) {
    const int ns = nvec - c0 < slice ? nvec - c0 : slice;  // vectors of this slice
    const int ds = ns * VW;                                 // its floats
    const int per = kRowStage / ds < kRowSlots ? kRowStage / ds : kRowSlots;  // slots a batch
    const int ne = nr * ns;
    int row[kTileElems], col[kTileElems];
    bool mine[kTileElems];  // a vector of a row of at most `chunk` slots
    float acc[kTileElems][VW];
#pragma unroll
    for (int i = 0; i < kTileElems; ++i) {
      const int e = threadIdx.x + i * kRowThreads;
      row[i] = e < ne ? e / ns : 0;
      col[i] = e < ne ? e - row[i] * ns : 0;  // within the slice
      mine[i] = e < ne && rs[row[i] + 1] - rs[row[i]] <= chunk;
#pragma unroll
      for (int k = 0; k < VW; ++k) acc[i][k] = 0.f;
    }
    for (int b0 = 0; b0 < S; b0 += per) {  // the short rows' slots, `per` at a time
      const int nb = S - b0 < per ? S - b0 : per;
      for (int u = threadIdx.x; u < nb; u += kRowThreads) {
        const int at = b0 + u;
        int lo = 0, hi = nr;  // vs[lo] <= at < vs[hi]: row lo holds slot `at`
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (vs[mid] <= at) {
            lo = mid;
          } else {
            hi = mid;
          }
        }
        const int slot = __ldg(order + rs[lo] + (at - vs[lo]));
        srow[u] = slot / L;
        if (kWeighted) sw[u] = __ldg(weights + slot);
      }
      __syncthreads();
      for (int f = threadIdx.x; f < nb * ns; f += kRowThreads) {
        const int u = f / ns, c = f - u * ns;
        cp_async<4 * VW>(stage + u * ds + c * VW,
                         grad + static_cast<int64_t>(srow[u]) * D + (c0 + c) * VW);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kTileElems; ++i) {
        if (!mine[i]) continue;
        const int a = max(vs[row[i]], b0), z = min(vs[row[i] + 1], b0 + nb);
        for (int u = a - b0; u < z - b0; ++u) {  // the row's slots in this batch, in order
          float x[VW];
          if constexpr (VW == 4) {
            const float4 v = *reinterpret_cast<const float4*>(stage + u * ds + col[i] * VW);
            x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
          } else if constexpr (VW == 2) {
            const float2 v = *reinterpret_cast<const float2*>(stage + u * ds + col[i] * VW);
            x[0] = v.x; x[1] = v.y;
          } else {
            x[0] = stage[u * ds + col[i]];
          }
          const float wt = kWeighted ? sw[u] : 1.f;
#pragma unroll
          for (int k = 0; k < VW; ++k) {
            acc[i][k] = __fadd_rn(acc[i][k], kWeighted ? __fmul_rn(x[k], wt) : x[k]);
          }
        }
      }
      __syncthreads();  // srow and the stage are free for the next batch
    }
#pragma unroll
    for (int i = 0; i < kTileElems; ++i) {
      if (mine[i]) {
        store_floats<VW>(out + (v0 + row[i]) * D + static_cast<int64_t>(c0 + col[i]) * VW,
                         acc[i]);
      }
    }
  }
}

template <int VW>
cudaError_t launch_backward(const float* grad, const int32_t* order, const float* weights,
                            const int32_t* row_start, const int32_t* chunk_base, float* partials,
                            int32_t* chunk_row, int max_chunks, int V, int D, int L, int chunk,
                            float* out, cudaStream_t stream) {
  const int chunk_blocks = max_chunks < kChunkBlocks ? max_chunks : kChunkBlocks;
  bag_grad_chunks_kernel<VW><<<chunk_blocks, kChunkThreads, 0, stream>>>(
      grad, order, weights, row_start, chunk_base, V, D, L, chunk, partials, chunk_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kCombineBytes = 2 * kCombineStage * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(bag_grad_combine_kernel<VW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kCombineBytes);
  if (err != cudaSuccess) return err;
  const int combine_grid = max_chunks < kCombineBlocks ? max_chunks : kCombineBlocks;
  bag_grad_combine_kernel<VW><<<combine_grid, kCombineThreads, kCombineBytes, stream>>>(
      partials, chunk_base, chunk_row, V, D, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nvec = D / VW;
  // vectors a slice: the block's threads hold them all, and a slot's slice fits the stage
  constexpr int most = kRowThreads * kTileElems < kSliceCols / VW ? kRowThreads * kTileElems
                                                                   : kSliceCols / VW;
  const int slice = nvec < most ? nvec : most;
  int tile_rows = kRowThreads * kTileElems / slice;
  tile_rows = tile_rows > kMaxTileRows ? kMaxTileRows : tile_rows;
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(V) + tile_rows - 1) / tile_rows));
  if (weights != nullptr) {
    bag_grad_rows_kernel<VW, true><<<grid, kRowThreads, 0, stream>>>(
        grad, order, weights, row_start, V, D, L, chunk, tile_rows, slice, out);
  } else {
    bag_grad_rows_kernel<VW, false><<<grid, kRowThreads, 0, stream>>>(
        grad, order, weights, row_start, V, D, L, chunk, tile_rows, slice, out);
  }
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

// Kernel 5': grad (B, D) float32; order, row_start and chunk_base (V + 1)
// int32 from the preparation (bag_plan.cu, or backward_plan); weights
// (B * L) float32 or NULL; partials (max_chunks x D floats) and chunk_row
// (max_chunks int32) are scratch, with 1 <= max_chunks and chunk_base[V] <=
// max_chunks; the plan's chunks are kChunk slots.  Writes out (V, D)
// float32, every row.
// Launches the chunk pass, the combine and the row pass on `stream`; returns
// the first cudaError_t (0 on success).
extern "C" int embedding_bag_backward_launch(const float* grad, const int32_t* order,
                                             const float* weights, const int32_t* row_start,
                                             const int32_t* chunk_base, float* partials,
                                             int32_t* chunk_row, int max_chunks, int V, int D,
                                             int L, float* out, void* stream) {
  if (V <= 0 || D <= 0) return 0;
  if (L <= 0 || max_chunks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t at = reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(partials);
  if (D % 4 == 0 && at % 16 == 0) {
    return launch_backward<4>(grad, order, weights, row_start, chunk_base, partials, chunk_row,
                              max_chunks, V, D, L, kChunk, out, s);
  }
  if (D % 2 == 0 && at % 8 == 0) {
    return launch_backward<2>(grad, order, weights, row_start, chunk_base, partials, chunk_row,
                              max_chunks, V, D, L, kChunk, out, s);
  }
  return launch_backward<1>(grad, order, weights, row_start, chunk_base, partials, chunk_row,
                            max_chunks, V, D, L, kChunk, out, s);
}
