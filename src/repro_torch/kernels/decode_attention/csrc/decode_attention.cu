// Single-token decode attention (flash-decoding) for Hopper (sm_90a).
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py, body _kernel) and
// the head repeat of its ops.py.  For every sequence b and q head h, with
// g = h / (Hq / Hkv) its KV head and n = pos[b] valid cache rows:
//
//   out[b, h] = softmax((q[b, h] / sqrt(D)) . K[b, :n, g]^T) . V[b, :n, g]
//
// in float32, the output in q's dtype (float32 or bfloat16).
//
// Bound on the H100: bytes.  Each call must read n rows of K and of V for
// every (b, g), 2 D sizeof(T) bytes a row, and does Hg = Hq / Hkv multiply-adds
// per element it reads, about 2 flops a byte at Hg = 6: far below the card's
// operations-per-byte balance, so the time is the cache's bytes over 3.35 TB/s.
//
// What the design does about it:
// - K/V are read once, never repeated per q head: a CTA owns one
//   (b, KV head g, chunk of at most 8 of g's q heads, row range) and keeps
//   those q rows in shared memory as float32, pre-scaled by 1/sqrt(D) (and
//   by log2(e), so the softmax runs on exp2).
// - Each warp streams tiles of 32 rows: it stages a tile's K and V rows in
//   shared memory with 16-byte cp.async copies (coalesced, no registers held
//   while they fly; 4 warps and 3 CTAs an SM keep up to ~200 KB in flight).  Then
//   phase 1 gives each lane one row: it computes that row's scores for all
//   the CTA's heads on its own, with no cross-lane reduction; one shuffle
//   max per head gives the tile's max, and the online softmax (m, l, acc)
//   is rescaled once per tile.  Phase 2 splits D over the lanes (4
//   elements each) and sums p . V over the tile's rows, p read from shared
//   memory.
// - Only rows < pos[b] are read.  The TPU kernel visits every tile and
//   masks; masked rows add exactly 0 once the running max is finite, so
//   stopping at pos[b] computes the same function.
// - The rows of each (b, g) are cut into `splits` ranges (flash-decoding):
//   B Hkv CTAs alone would leave most of the 132 SMs idle.  Each CTA merges
//   its warps through shared memory and writes one partial (m, l, acc[h, D])
//   to float32 scratch; combine_kernel merges the ranges of a (b, h) and
//   writes out.
// Left for later: double-buffered tiles, TMA, tensor cores, a persistent
// grid.  The domain is 1 <= pos[b] <= S; pos = 0 gives 0, where the TPU
// kernel averages V over its padded tile.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;   // warps a CTA
constexpr int kTile = 32;   // rows a warp stages at a time: one a lane in phase 1
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The 16 bytes of a row slice as float32: 4 floats, or 8 bfloat16 (a
// bfloat16 is the high half of a float32).
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  int B, S, Hq, Hkv, splits, rows;
  float scale;
  float* part_m;
  float* part_l;
  float* part_acc;
  void* out;
};

// 16 bytes global -> shared, asynchronously; zeros (and no read) when !ok.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp copies rows t .. t + kTile - 1 (zeros past hi) of a K or V head,
// kBytes a row, into shared memory rows kDst bytes apart.
template <int kBytes, int kDst>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const unsigned char* src,
                                           size_t src_stride, int t, int hi, int lane) {
  constexpr int kChunks = kBytes / 16;
#pragma unroll
  for (int i = lane; i < kTile * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = t + r < hi;
    const size_t off = ok ? static_cast<size_t>(t + r) * src_stride + c * 16 : 0;
    cp_async16(dst + r * kDst + c * 16, src + off, ok);
  }
}

// Four elements of a V row slice as float32 (8 bytes of bfloat16, 16 of float).
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(x.x << 16);
  f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16);
  f[3] = __uint_as_float(x.y & 0xffff0000u);
}

// Shared memory of a CTA: the q rows [HT][D] as float32, then per warp its
// tile: K rows [kTile][D] padded by 16 bytes (so that lane-per-row reads
// fall in distinct banks), V rows [kTile][D], and p [HT][kTile].  After the
// row loop the tiles hold the warps' partials for the CTA merge.
template <typename T, int D, int HT>
struct Smem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kKStride = kRowBytes + 16;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kQBytes = HT * D * 4;
  static constexpr int kWarpBytes = kTile * (kKStride + kRowBytes) + HT * kTile * 4;
  static constexpr int kBytes = kQBytes + kWarps * kWarpBytes;
  static_assert(kWarps * HT * (D + 2) * 4 <= kWarps * kWarpBytes, "merge buffers fit");
};

// Grid (splits, Hkv * head chunks, B), kWarps warps a CTA.
template <typename T, int D, int HT>
__global__ void __launch_bounds__(kWarps * 32)
attend_kernel(Args a) {
  using L = Smem<T, D, HT>;
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int LPRV = D / 4;          // phase 2: lanes per row, 4 elements each
  constexpr int PASSES = kTile * LPRV / 32;
  static_assert(LPRV >= 2 && LPRV <= 32 && PASSES % 2 == 0, "D must be 8..128");

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const int Hg = a.Hq / a.Hkv;
  const int nchunks = (Hg + HT - 1) / HT;
  const int g = blockIdx.y / nchunks;
  const int h0 = g * Hg + (blockIdx.y % nchunks) * HT;  // first q head of the CTA
  const int nh = min(HT, (g + 1) * Hg - h0);
  const int b = blockIdx.z;
  const int s = blockIdx.x;
  const int len = min(max(a.pos[b], 0), a.S);
  const int lo = s * a.rows;
  const int hi = min(lo + a.rows, len);
  if (lo >= hi) return;  // a range past pos[b]: combine_kernel skips it

  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* k_s = smem + L::kQBytes + warp * L::kWarpBytes;
  unsigned char* v_s = k_s + kTile * L::kKStride;
  float* p_s = reinterpret_cast<float*>(v_s + kTile * L::kRowBytes);

  for (int i = threadIdx.x; i < HT * D; i += blockDim.x) {
    const int h = i / D;
    q_s[i] = h < nh
        ? to_float(q[(static_cast<size_t>(b) * a.Hq + h0 + h) * D + i % D]) * a.scale * kLog2e
        : 0.f;
  }
  __syncthreads();

  float m[HT], l[HT], acc[HT][4];
#pragma unroll
  for (int h = 0; h < HT; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
  }
  const int pg = lane / LPRV;        // phase 2: this lane's rows pg * PASSES + ps
  const int pd = (lane % LPRV) * 4;  // and its 4 elements
  const size_t stride = static_cast<size_t>(a.Hkv) * L::kRowBytes;  // bytes between rows
  const size_t head = (static_cast<size_t>(b) * a.S * a.Hkv + g) * L::kRowBytes;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + head;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + head;

  // K and V of a tile are separate copy groups: the next tile's K rows fly
  // during this tile's phase 2, its V rows during the next phase 1
  int t = lo + warp * kTile;
  if (t < hi) stage_rows<L::kRowBytes, L::kKStride>(k_s, kg, stride, t, hi, lane);
  cp_async_commit();
  if (t < hi) stage_rows<L::kRowBytes, L::kRowBytes>(v_s, vg, stride, t, hi, lane);
  cp_async_commit();
  for (; t < hi; t += kWarps * kTile) {
    const int next = t + kWarps * kTile;
    cp_async_wait<1>();  // this tile's K
    __syncwarp();

    // phase 1: lane = row; its scores for the CTA's heads
    const bool valid = t + lane < hi;
    float sc[HT];
#pragma unroll
    for (int h = 0; h < HT; ++h) sc[h] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      float kf[VEC];
      unpack(*reinterpret_cast<const uint4*>(k_s + lane * L::kKStride + c * 16), kf);
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const float4* qh = reinterpret_cast<const float4*>(q_s + h * D + c * VEC);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {  // one broadcast 16-byte read per 4 elements
          const float4 qv = qh[e];
          sc[h] = fmaf(qv.x, kf[4 * e], sc[h]);
          sc[h] = fmaf(qv.y, kf[4 * e + 1], sc[h]);
          sc[h] = fmaf(qv.z, kf[4 * e + 2], sc[h]);
          sc[h] = fmaf(qv.w, kf[4 * e + 3], sc[h]);
        }
      }
    }
    // online softmax over the tile: the warp shares m; l is per lane
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      const float sv = valid ? sc[h] : -INFINITY;
      float tmax = sv;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
      const float mn = fmaxf(m[h], tmax);  // finite: row t is valid
      const float corr = exp2f(m[h] - mn);
      const float p = valid ? exp2f(sv - mn) : 0.f;
      l[h] = l[h] * corr + p;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] *= corr;
      m[h] = mn;
      p_s[h * kTile + lane] = p;
    }
    __syncwarp();  // every lane is done with k_s
    if (next < hi) stage_rows<L::kRowBytes, L::kKStride>(k_s, kg, stride, next, hi, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's V
    __syncwarp();
    // phase 2: lanes split D; each lane group sums its rows' p . V
#pragma unroll
    for (int ps = 0; ps < PASSES; ps += 2) {
      const int j = pg * PASSES + ps;
      float v0[4], v1[4];
      load4(reinterpret_cast<const T*>(v_s + j * L::kRowBytes) + pd, v0);
      load4(reinterpret_cast<const T*>(v_s + (j + 1) * L::kRowBytes) + pd, v1);
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const float2 pp = *reinterpret_cast<const float2*>(p_s + h * kTile + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(pp.y, v1[e], fmaf(pp.x, v0[e], acc[h][e]));
      }
    }
    __syncwarp();  // every lane is done with v_s and p_s
    if (next < hi) stage_rows<L::kRowBytes, L::kRowBytes>(v_s, vg, stride, next, hi, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the warp's totals: l over all lanes, acc over the lane groups
#pragma unroll
  for (int h = 0; h < HT; ++h) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) l[h] += __shfl_xor_sync(kFull, l[h], off);
#pragma unroll
    for (int off = LPRV; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] += __shfl_xor_sync(kFull, acc[h][e], off);
    }
  }

  // merge the warps through shared memory and write the CTA's partial
  __syncthreads();  // every warp is done with its tiles
  float* sm_m = reinterpret_cast<float*>(smem + L::kQBytes);  // [kWarps][HT]
  float* sm_l = sm_m + kWarps * HT;                             // [kWarps][HT]
  float* sm_acc = sm_l + kWarps * HT;                           // [kWarps][HT][D]
  if (lane < LPRV) {
#pragma unroll
    for (int h = 0; h < HT; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sm_acc[(warp * HT + h) * D + pd + e] = acc[h][e];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      sm_m[warp * HT + h] = m[h];
      sm_l[warp * HT + h] = l[h];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += blockDim.x) {
    const int h = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * HT + h]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w * HT + h];
      if (mw == -INFINITY) continue;  // a warp with no row
      const float c = exp2f(mw - M);
      Ls += sm_l[w * HT + h] * c;
      A += sm_acc[(w * HT + h) * D + d] * c;
    }
    const size_t idx = (static_cast<size_t>(b) * a.Hq + h0 + h) * a.splits + s;
    a.part_acc[idx * D + d] = A;
    if (d == 0) {
      a.part_m[idx] = M;
      a.part_l[idx] = Ls;
    }
  }
}

// Grid (Hq, B), D threads: merge the ranges of (b, h) that hold rows.
template <typename T>
__global__ void combine_kernel(Args a, int D) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(max(a.pos[b], 0), a.S);
  const int n = (len + a.rows - 1) / a.rows;
  const size_t base = (static_cast<size_t>(b) * a.Hq + h) * a.splits;
  float M = -INFINITY;
  for (int s = 0; s < n; ++s) M = fmaxf(M, a.part_m[base + s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n; ++s) {
    const float c = exp2f(a.part_m[base + s] - M);
    L += a.part_l[base + s] * c;
    A += a.part_acc[(base + s) * D + d] * c;
  }
  static_cast<T*>(a.out)[(static_cast<size_t>(b) * a.Hq + h) * D + d] =
      from_float<T>(A / fmaxf(L, 1e-30f));
}

// Launch the kernels for `a`, or, with `occupancy` set, write there how many
// attention CTAs an SM holds at once and launch nothing.
template <typename T, int D, int HT>
cudaError_t run(const Args& a, cudaStream_t stream, int* occupancy) {
  constexpr int smem = Smem<T, D, HT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attend_kernel<T, D, HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, attend_kernel<T, D, HT>,
                                                         kWarps * 32, smem);
  const int nchunks = (a.Hq / a.Hkv + HT - 1) / HT;
  attend_kernel<T, D, HT>
      <<<dim3(a.splits, a.Hkv * nchunks, a.B), kWarps * 32, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<dim3(a.Hq, a.B), D, 0, stream>>>(a, D);
  return cudaGetLastError();
}

// q heads a CTA holds: the group's heads rounded up to 1, 2, 4, 6 or 8;
// larger groups are cut into chunks of 8.  The rows past the group's heads
// are zero q rows: computed, never written.
template <typename T, int D>
cudaError_t run_ht(const Args& a, cudaStream_t stream, int* occupancy) {
  const int hg = a.Hq / a.Hkv;
  if (hg == 1) return run<T, D, 1>(a, stream, occupancy);
  if (hg == 2) return run<T, D, 2>(a, stream, occupancy);
  if (hg <= 4) return run<T, D, 4>(a, stream, occupancy);
  if (hg <= 6) return run<T, D, 6>(a, stream, occupancy);
  return run<T, D, 8>(a, stream, occupancy);
}

template <typename T>
cudaError_t run_d(const Args& a, int D, cudaStream_t stream, int* occupancy) {
  switch (D) {
    case 8: return run_ht<T, 8>(a, stream, occupancy);
    case 16: return run_ht<T, 16>(a, stream, occupancy);
    case 32: return run_ht<T, 32>(a, stream, occupancy);
    case 64: return run_ht<T, 64>(a, stream, occupancy);
    case 128: return run_ht<T, 128>(a, stream, occupancy);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run_dtype(const Args& a, int dtype, int D, cudaStream_t stream, int* occupancy) {
  switch (dtype) {
    case 0: return run_d<float>(a, D, stream, occupancy);
    case 1: return run_d<__nv_bfloat16>(a, D, stream, occupancy);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// How many attention CTAs an SM holds at once for this dtype (0 float32,
// 1 bfloat16), head dim and group size Hq / Hkv; written to *ctas.
// Returns the cudaError_t (0 on success).
extern "C" int decode_attention_occupancy(int dtype, int D, int group, int* ctas) {
  if (group < 1) return cudaErrorInvalidValue;
  Args a{};
  a.Hq = group;
  a.Hkv = 1;
  return run_dtype(a, dtype, D, nullptr, ctas);
}

// q (B, Hq, D), k and v (B, S, Hkv, D), all of one dtype (0 float32,
// 1 bfloat16), contiguous and 16-byte aligned; pos (B,) int32.  The rows of
// each (b, KV head) are cut into `splits` ranges of `rows` rows; part_m,
// part_l (B, Hq, splits) and part_acc (B, Hq, splits, D) are float32
// scratch.  Writes out (B, Hq, D) in the dtype of q.  `scale` is 1/sqrt(D).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* pos, int B, int S, int Hq, int Hkv, int D,
                                       int dtype, int splits, int rows, float scale,
                                       float* part_m, float* part_l, float* part_acc,
                                       void* out, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || splits < 1 || rows < 1 ||
      static_cast<long long>(splits) * rows < S || B > 65535 || Hq > 65535)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, pos, B, S, Hq, Hkv, splits, rows, scale, part_m, part_l, part_acc, out};
  return run_dtype(a, dtype, D, static_cast<cudaStream_t>(stream), nullptr);
}
