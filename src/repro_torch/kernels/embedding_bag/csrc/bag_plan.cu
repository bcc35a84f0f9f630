// The preparation of kernel 5' (the EmbeddingBag backward) for Hopper
// (sm_90a): the port's own stable sort of a lookup's slots by id.
//
// It replaces no TPU kernel: the JAX package differentiates jnp.take and
// has no backward kernel.  Given N = B * L int32 ids and a table of V rows,
// it computes backward_plan's grouping (ref.py) without torch.sort or
// torch.searchsorted:
//
//   order      the slots 0 <= i < N whose id lies in [0, V), stably sorted
//              by id: order[0 .. row_start[V]) equals backward_plan's (the
//              padding slots, which backward_plan places last, are dropped
//              here and order's tail is left unwritten);
//   row_start  (V + 1) row v's slots are order[row_start[v] .. row_start[v + 1]);
//   chunk_base (V + 1) the exclusive prefix sum of the chunk counts, a row of
//              c > kChunk slots counting ceil(c / kChunk) chunks, others none
//              (kChunk = 1024, BACKWARD_CHUNK in ref.py and kernel 5''s chunk).
//
// Bound on the H100: bandwidth.  A call must read the ids once and write
// order, row_start and chunk_base once: at train_batch's lookup (3,276,800
// ids, V = 2^20) 34.6 MB, 0.0103 ms at 3.35 TB/s.
//
// Design.  An LSD radix sort of (key, slot) int32 pairs over only the bits
// that V - 1 needs, at most kMaxDigitBits a pass, the bits split evenly (20
// at V = 2^20: three passes of 7 bits).  The first pass reads the ids
// themselves, drops the padding and takes the flat index as the slot.  A
// tile of kTile keys holds ~kTile / 2^bits keys of a digit, and the scatter
// stores each digit's run of them at once: two passes of 10 bits (runs of
// ~4 keys, partial-sector stores) and a onesweep pass with decoupled
// look-back both measured slower on the H100 than three passes of 7 bits
// in three launches each.  Each pass is three launches over tiles of kTile
// keys:
//   hist     a shared-memory histogram of the tile's digits (integer
//            atomics: counts, whose result does not depend on order),
//            written digit-major;
//   scan     one block a digit: the exclusive prefix of its count over the
//            tiles, and the digit's total;
//   scatter  all its loads first (keys, slots, the digit's total and its
//            count in earlier tiles); then the tile's keys ranked stably:
//            warp w of a tile holds its keys w * 32 * kItems .. in rounds of
//            32 lanes; a round finds each lane's peers of the same digit by
//            one ballot a digit bit, and a warp's own shared histogram, read
//            and advanced by each digit's lowest lane, gives every key its
//            rank among the warp's earlier keys of its digit; the tile's
//            warps before this one, and the digits before this one, give its
//            place in the tile.
//            The tile's keys and slots are staged there in digit order and
//            stored a digit's run at a time (coalesced), at the digit's start
//            plus its keys in earlier tiles.  No atomic decides a position.
// A key's place thus depends on the keys before it only, so the sort is
// stable and the result is the same bits every call.  Then:
//   bounds   one thread a sorted position i: where the key changes (and at
//            both ends) it writes row_start[k] = i for every row k between
//            the two keys when they are at most kGapRows apart, so each
//            entry is written at most once and no thread writes more than
//            kGapRows;
//   fill     one thread a row: a row left at -1 (row_start is set to -1
//            first), in a gap longer than kGapRows between the ids present,
//            takes the first sorted position whose key is not below it, by
//            binary search (only sparse ids against V reach it: a single id
//            at V = 2^20 leaves ~2^20 such rows, which one thread of the
//            bounds pass would otherwise write one after another);
//   chunks   chunk_base by a scan of the rows' chunk counts in two launches:
//            a sum a block of rows, then each block's prefix (the sums of
//            the blocks before it) and its rows' exclusive scan.
// Scratch (int32, embedding_bag_plan_words): the ping-pong key and slot
// arrays, the tile x digit counts, the digit totals, the block sums and the
// count of valid slots.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // keys a thread holds in a radix pass
constexpr int kTile = kThreads * kItems;       // keys a block of a radix pass takes
constexpr int kMaxDigitBits = 8;
constexpr int kMaxBins = 1 << kMaxDigitBits;
static_assert(kMaxBins <= kThreads, "a thread of a pass keeps one digit");
constexpr int kRowBlock = 1024;               // rows a block of the chunk scan takes, at least
constexpr int kMaxRowBlocks = 2048;            // blocks of the chunk scan, at most
constexpr int kGapRows = 32;                   // rows a thread of the bounds pass writes, at most
constexpr int kChunk = 1024;                   // slots a chunk of a long row: BACKWARD_CHUNK

// Exclusive prefix sum of one int a thread across the block (thread order);
// the block's sum in *total.  Every thread of the block must call it.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    sum += s;
  }
  __syncthreads();  // warp_sums is free for the next call
  *total = sum;
  return before + incl - x;
}

__device__ __forceinline__ int digit_of(int key, int shift, int bits) {
  return (key >> shift) & ((1 << bits) - 1);
}

// The lanes of `valid` whose digit equals this lane's: one ballot a digit
// bit (a warp multisplit; __match_any_sync costs a pass for each distinct
// value, ~30 of them a round at 1,024 digits).
__device__ __forceinline__ unsigned lanes_of_digit(int d, int bits, unsigned valid) {
  unsigned peers = valid;
  for (int b = 0; b < bits; ++b) {
    const bool set = (d >> b) & 1;
    const unsigned m = __ballot_sync(kFull, set);
    peers &= set ? m : ~m;
  }
  return peers;
}

// The tile's keys: warp w, round r, lane l holds key tile * kTile +
// w * 32 * kItems + r * 32 + l (coalesced rounds; the tile's order is the
// input's).  The loads are issued before the count of keys is known: every
// index below N lies in the arrays.  ok(): the first pass keeps the ids in
// [0, V); a later pass the first n keys of the pass before, all valid.
__device__ __forceinline__ int64_t tile_index(int r) {
  return static_cast<int64_t>(blockIdx.x) * kTile + (threadIdx.x >> 5) * (32 * kItems) +
         (threadIdx.x & 31) + r * 32;
}

template <bool kFirst>
__device__ __forceinline__ bool key_ok(int key, int64_t i, int n, int V) {
  return kFirst ? key >= 0 && key < V : i < n;
}

// counts[d * tiles + tile]: the tile's keys of digit d (digit-major, so that
// the scan reads each digit's counts contiguously).
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
plan_hist_kernel(const int32_t* __restrict__ keys, int N, const int32_t* __restrict__ n_valid,
                 int V, int shift, int bits, int* __restrict__ counts) {
  __shared__ int hist[kMaxBins];
  const int bins = 1 << bits;
  const int n = kFirst ? N : __ldg(n_valid);
  int key[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) key[r] = tile_index(r) < N ? __ldg(keys + tile_index(r)) : -1;
  if (threadIdx.x < bins) hist[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (key_ok<kFirst>(key[r], tile_index(r), n, V)) {
      atomicAdd(&hist[digit_of(key[r], shift, bits)], 1);  // a count: order-free
    }
  }
  __syncthreads();
  if (threadIdx.x < bins) {
    counts[static_cast<int64_t>(threadIdx.x) * gridDim.x + blockIdx.x] = hist[threadIdx.x];
  }
}

// One block a digit d: counts[d * tiles + t] becomes the count of d's keys in
// the tiles before t (a block scan a round of kThreads tiles, carried);
// totals[d] the count of d's keys.
__global__ void __launch_bounds__(kThreads)
plan_scan_kernel(int* __restrict__ counts, int tiles, int* __restrict__ totals) {
  int* row = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  int run = 0;
  for (int t0 = 0; t0 < tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int c = t < tiles ? row[t] : 0;
    int total;
    const int before = block_exclusive_sum(c, &total);
    if (t < tiles) row[t] = run + before;
    run += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = run;
}

// Every valid key of the tile to its place (see the note above).  All its
// loads (the keys, their slots, the digit's total and earlier tiles' count)
// are issued first, together.  The tile's keys are ranked in shared memory,
// staged there in digit order and written out a digit's run at a time, so
// that neighbouring threads store to neighbouring addresses.  The first pass
// writes the count of valid slots to *n_valid; later passes read it.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads, 4)
plan_scatter_kernel(const int32_t* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
                    int N, int32_t* __restrict__ n_valid, int V, int shift, int bits,
                    const int* __restrict__ counts, const int* __restrict__ totals,
                    int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out) {
  // the warps' digit counts, then (reused) the tile's keys and slots in digit order
  __shared__ int shared[kWarps * kMaxBins > 2 * kTile ? kWarps * kMaxBins : 2 * kTile];
  __shared__ int global_base[kMaxBins];  // where the tile's keys of digit d go
  __shared__ int tile_start[kMaxBins];   // where they start among the tile's keys
  int (*warp_hist)[kMaxBins] = reinterpret_cast<int (*)[kMaxBins]>(shared);
  int* stage_keys = shared;
  int* stage_vals = shared + kTile;
  const int bins = 1 << bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = threadIdx.x;  // the digit this thread keeps
  const int total_d = d < bins ? __ldg(totals + d) : 0;
  const int before_d = d < bins ? __ldg(counts + static_cast<int64_t>(d) * gridDim.x + blockIdx.x)
                                : 0;
  const int n = kFirst ? N : __ldg(n_valid);
  int key[kItems], val[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = tile_index(r);
    key[r] = i < N ? __ldg(keys_in + i) : -1;
    val[r] = kFirst ? static_cast<int>(i) : (i < N ? __ldg(vals_in + i) : 0);
  }
  for (int b = lane; b < bins; b += 32) warp_hist[warp][b] = 0;
  {  // global_base[d]: the keys of the smaller digits, then d's keys in earlier tiles
    int total;
    const int start = block_exclusive_sum(total_d, &total);
    if (d < bins) global_base[d] = start + before_d;
    if (kFirst && blockIdx.x == 0 && threadIdx.x == 0) *n_valid = total;
  }
  bool ok[kItems];
  int rank[kItems];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {  // rank within the warp, round by round
    ok[r] = key_ok<kFirst>(key[r], tile_index(r), n, V);
    const int dr = ok[r] ? digit_of(key[r], shift, bits) : 0;
    const unsigned peers = lanes_of_digit(dr, bits, __ballot_sync(kFull, ok[r]));
    const int leader = __ffs(peers) - 1;
    int seen = 0;
    if (ok[r] && lane == leader) seen = warp_hist[warp][dr];
    seen = __shfl_sync(kFull, seen, leader);
    rank[r] = seen + __popc(peers & below);
    if (ok[r] && lane == leader) warp_hist[warp][dr] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int count = 0;  // the tile's keys of digit d
  if (d < bins) {
    for (int w = 0; w < kWarps; ++w) count += warp_hist[w][d];
  }
  int tile_keys;
  const int start = block_exclusive_sum(count, &tile_keys);
  if (d < bins) {  // d's start in the tile, and each warp's start within the digit
    tile_start[d] = start;
    int run = start;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_hist[w][d];
      warp_hist[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {  // rank becomes the place among the tile's keys
    if (ok[r]) rank[r] += warp_hist[warp][digit_of(key[r], shift, bits)];
  }
  __syncthreads();  // warp_hist is read: its memory takes the staged keys
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (ok[r]) {
      stage_keys[rank[r]] = key[r];
      stage_vals[rank[r]] = val[r];
    }
  }
  __syncthreads();
  for (int at = threadIdx.x; at < tile_keys; at += kThreads) {
    const int k = stage_keys[at];
    const int dk = digit_of(k, shift, bits);
    const int pos = global_base[dk] + at - tile_start[dk];
    keys_out[pos] = k;
    vals_out[pos] = stage_vals[at];
  }
}

// One thread a sorted position i in [0, n]: row_start[k] = i for the rows k
// after the key before i and up to the key at i (-1 before the first, V at
// n), unless there are more than kGapRows of them: the fill pass takes those.
__global__ void __launch_bounds__(kThreads)
plan_bounds_kernel(const int32_t* __restrict__ sorted, const int32_t* __restrict__ n_valid, int V,
                   int32_t* __restrict__ row_start) {
  const int n = __ldg(n_valid);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i > n) return;
  const int prev = i == 0 ? -1 : __ldg(sorted + i - 1);
  const int cur = i == n ? V : __ldg(sorted + i);
  if (cur - prev > kGapRows) return;
  for (int k = prev + 1; k <= cur; ++k) row_start[k] = static_cast<int>(i);
}

// One thread a row k in [0, V]: where the bounds pass left -1, the first
// sorted position whose key is at least k (n when none is).
__global__ void __launch_bounds__(kThreads)
plan_fill_kernel(const int32_t* __restrict__ sorted, const int32_t* __restrict__ n_valid, int V,
                 int32_t* __restrict__ row_start) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k > V || row_start[k] >= 0) return;
  int lo = 0, hi = __ldg(n_valid);  // sorted[lo - 1] < k <= sorted[hi]
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(sorted + mid) < k) lo = mid + 1; else hi = mid;
  }
  row_start[k] = lo;
}

__device__ __forceinline__ int chunks_of(const int32_t* __restrict__ row_start, int64_t v) {
  const int c = __ldg(row_start + v + 1) - __ldg(row_start + v);
  return c > kChunk ? c / kChunk + (c % kChunk != 0) : 0;
}

// block_sums[b]: the chunks of rows [b * rows, (b + 1) * rows).
__global__ void __launch_bounds__(kThreads)
plan_chunk_sums_kernel(const int32_t* __restrict__ row_start, int V, int rows,
                       int* __restrict__ block_sums) {
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t v1 = v0 + rows < V ? v0 + rows : V;
  int sum = 0;
  for (int64_t v = v0 + threadIdx.x; v < v1; v += kThreads) sum += chunks_of(row_start, v);
  int total;
  block_exclusive_sum(sum, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// chunk_base over the block's rows: the sums of the blocks before it, then
// an exclusive scan of its rows' chunks, kThreads rows a round (carried); the
// block that holds row V - 1 also writes chunk_base[V].
__global__ void __launch_bounds__(kThreads)
plan_chunk_base_kernel(const int32_t* __restrict__ row_start, int V, int rows,
                       const int* __restrict__ block_sums, int32_t* __restrict__ chunk_base) {
  int before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kThreads) {
    before += __ldg(block_sums + b);
  }
  int run;
  block_exclusive_sum(before, &run);
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t v1 = v0 + rows < V ? v0 + rows : V;
  for (int64_t s = v0; s < v1; s += kThreads) {
    const int64_t v = s + threadIdx.x;
    const int c = v < v1 ? chunks_of(row_start, v) : 0;
    int total;
    const int at = run + block_exclusive_sum(c, &total);
    if (v < v1) chunk_base[v] = at;
    run += total;
  }
  if (v1 == V && threadIdx.x == 0) chunk_base[V] = run;
}

// The sort's shape for N ids and V rows: its passes, bits a digit, tiles,
// and the chunk scan's rows a block and blocks.
struct Shape {
  int bits, passes, digit_bits, tiles, rows, row_blocks;
};

Shape shape_of(int N, int V) {
  Shape s;
  s.bits = V > 1 ? 32 - __builtin_clz(static_cast<unsigned>(V - 1)) : 0;
  s.passes = s.bits > 0 ? (s.bits + kMaxDigitBits - 1) / kMaxDigitBits : 1;
  s.digit_bits = (s.bits + s.passes - 1) / s.passes;
  s.tiles = N > 0 ? static_cast<int>((static_cast<int64_t>(N) + kTile - 1) / kTile) : 1;
  const int64_t least = (static_cast<int64_t>(V) + kMaxRowBlocks - 1) / kMaxRowBlocks;
  const int64_t rows = least > kRowBlock ? (least + kRowBlock - 1) / kRowBlock * kRowBlock
                                         : kRowBlock;
  s.rows = static_cast<int>(rows);
  s.row_blocks = static_cast<int>((static_cast<int64_t>(V) + rows - 1) / rows);
  return s;
}

}  // namespace

// int32 words of scratch embedding_bag_plan_launch needs for N ids and V rows.
extern "C" long long embedding_bag_plan_words(int N, int V) {
  if (N < 0 || V < 1) return -1;
  const Shape s = shape_of(N, V);
  return 3LL * N + static_cast<long long>(s.tiles) * kMaxBins + kMaxBins + kMaxRowBlocks + 4;
}

// ids (N) int32; writes order (N; the first row_start[V] entries), row_start
// and chunk_base (V + 1) int32, as the note above says.  `scratch` holds at
// least embedding_bag_plan_words(N, V) int32 words.  Launches on `stream`;
// returns the first cudaError_t (0 on success).
extern "C" int embedding_bag_plan_launch(const int32_t* ids, int N, int V, int32_t* order,
                                         int32_t* row_start, int32_t* chunk_base,
                                         int32_t* scratch,
                                         long long scratch_words, void* stream) {
  if (N < 0 || V < 1) return cudaErrorInvalidValue;
  if (scratch_words < embedding_bag_plan_words(N, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = shape_of(N, V);
  int32_t* keys0 = scratch;            // the sorted keys (the last pass's)
  int32_t* keys1 = keys0 + N;
  int32_t* vals1 = keys1 + N;
  int* counts = vals1 + N;
  int* totals = counts + static_cast<int64_t>(s.tiles) * kMaxBins;
  int* block_sums = totals + kMaxBins;
  int32_t* n_valid = block_sums + kMaxRowBlocks;
  cudaError_t err;
  for (int p = 0; p < s.passes; ++p) {
    const int shift = p * s.digit_bits;
    const int rest = s.bits - shift;
    const int bits = rest < s.digit_bits ? rest : s.digit_bits;
    // the last pass writes order and keys0; the one before it keys1 and vals1
    const bool to_order = (s.passes - 1 - p) % 2 == 0;
    int32_t* k_out = to_order ? keys0 : keys1;
    int32_t* v_out = to_order ? order : vals1;
    const int32_t* k_in = to_order ? keys1 : keys0;
    const int32_t* v_in = to_order ? vals1 : order;
    if (p == 0) {
      plan_hist_kernel<true><<<s.tiles, kThreads, 0, st>>>(ids, N, n_valid, V, shift, bits,
                                                           counts);
    } else {
      plan_hist_kernel<false><<<s.tiles, kThreads, 0, st>>>(k_in, N, n_valid, V, shift, bits,
                                                            counts);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    plan_scan_kernel<<<1 << bits, kThreads, 0, st>>>(counts, s.tiles, totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (p == 0) {
      plan_scatter_kernel<true><<<s.tiles, kThreads, 0, st>>>(
          ids, nullptr, N, n_valid, V, shift, bits, counts, totals, k_out, v_out);
    } else {
      plan_scatter_kernel<false><<<s.tiles, kThreads, 0, st>>>(
          k_in, v_in, N, n_valid, V, shift, bits, counts, totals, k_out, v_out);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t rows = static_cast<int64_t>(V) + 1;
  if ((err = cudaMemsetAsync(row_start, 0xff, rows * sizeof(int32_t), st)) != cudaSuccess) {
    return err;
  }
  const int64_t positions = static_cast<int64_t>(N) + 1;
  plan_bounds_kernel<<<static_cast<unsigned>((positions + kThreads - 1) / kThreads), kThreads, 0,
                       st>>>(keys0, n_valid, V, row_start);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  plan_fill_kernel<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      keys0, n_valid, V, row_start);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  plan_chunk_sums_kernel<<<s.row_blocks, kThreads, 0, st>>>(row_start, V, s.rows, block_sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  plan_chunk_base_kernel<<<s.row_blocks, kThreads, 0, st>>>(row_start, V, s.rows, block_sums,
                                                            chunk_base);
  return cudaGetLastError();
}
