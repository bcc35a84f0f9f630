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
// Common to both bodies below:
// - K/V are read once, never repeated per q head: a CTA owns one
//   (b, KV head g, chunk of at most 8 of g's q heads, row range).
// - Only rows < pos[b] are read.  The TPU kernel visits every tile and
//   masks; masked rows add exactly 0 once the running max is finite, so
//   stopping at pos[b] computes the same function.
// - The rows of each (b, g) are cut into `splits` ranges (flash-decoding):
//   B Hkv CTAs alone would leave most of the 132 SMs idle.  Each CTA merges
//   its warps through shared memory and writes one partial (m, l, acc[h, D])
//   to float32 scratch; combine_kernel merges the ranges of a (b, h) and
//   writes out.  The softmax runs on exp2 of scores times scale * log2(e).
//
// bfloat16 at D = 16..128 (the serving path): attend_mma_kernel, tensor cores
// under a TMA ring.
// - One lane of a producer warp keeps kStages stages of kRows cache rows of
//   K and V in flight: a stage is D / 64 boxes of K and as many of V (one at
//   D <= 64), each a cp.async.bulk.tensor load of a 4-D tensor map over
//   (D, Hkv, S, B), completing on the stage's full mbarrier
//   (complete_tx::bytes).  The maps are built on the host for each launch
//   through cudaGetDriverEntryPoint (no link against libcuda),
//   with the 128-byte swizzle (64 or 32 at D = 32, 16), so that the 8 rows
//   an ldmatrix phase reads fall in 8 distinct bank groups.  A copy per
//   256-byte row (cp.async.bulk without a map) was measured first
//   (tools/attn_copy_floor.py): a producer issued about one copy every
//   30 ns, so its copies alone took 0.93 ms at one CTA an SM, 0.47 at two
//   and 0.35 at three at the 32 x 32k shape.
// - A range's last tile ends at its last row instead of starting after the
//   tile before it, so no row at or past pos[b] is ever read: the rows it
//   takes again (or the zeros the map gives before row 0) are masked.
// - kConsumers consumer warps take the stages round robin: stage s always
//   belongs to warp s % kConsumers, which waits on its full barrier and
//   arrives on its empty one, so no warp waits on a phase two ahead.
// - Both products run on mma.sync.m16n8k16 (bf16 in, float32 accumulate).
//   A is the CTA's q heads, rows 8..15 zero; S = Q K^T takes K from shared
//   memory by ldmatrix; the online softmax runs on the float32 accumulator
//   fragments; P, as a bf16 high part and a bf16 low part (two products),
//   is the A operand of P V straight from those fragments, with V by
//   ldmatrix.trans.  wgmma needs 64-row tiles: at 6 q heads a KV head they
//   would be over 90 % padding, so mma.sync is the fit.  q is used as
//   given: scale * log2(e) multiplies the float32 scores.  P's high part
//   alone adds up to 2^-9 relative error a term, and its rows read above
//   2^-8 of error in chip_smoke.py's phase 10 sweep (the limit is 2^-7);
//   with its low part, 2^-17 a term.
// - 4 consumer warps and 8 stages of 16 KB at D = 128 (one CTA an SM, 8
//   splits at the 32 x 32k shape): measured against 2 x 4 (three CTAs an
//   SM), 3 x 6 (two), 1 x 2..4 and 4 x 12, it read the least.  The loads
//   carry an L2 evict-first hint: the cache is read once.
// float32, and D = 8 at either dtype: attend_kernel, CUDA cores.  Tensor
// cores there would mean TF32 (about 3 digits, against a 1e-5 limit), and
// mma.sync takes D in multiples of 16.
// - Each warp streams tiles of 32 rows: it stages a tile's K and V rows in
//   shared memory with 16-byte cp.async copies, the q rows in shared memory
//   as float32, pre-scaled.  Phase 1 gives each lane one row: it computes
//   that row's scores for all the CTA's heads on its own; one shuffle max
//   per head gives the tile's max, and the online softmax (m, l, acc) is
//   rescaled once per tile.  Phase 2 splits D over the lanes (4 elements
//   each) and sums p . V over the tile's rows, p read from shared memory.
// Left for later: the split partials go through float32 scratch and a
// second launch (combine_kernel); the grid is not persistent, so each CTA
// pays its ring's fill and drain; the CUDA-core body keeps one tile in
// flight a warp.  The domain is 1 <= pos[b] <= S; pos = 0 gives 0, where the
// TPU kernel averages V over its padded tile.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
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

// ---- bfloat16 on tensor cores under a TMA ring ---------------------------

constexpr int kConsumers = 4;   // consumer warps a CTA
constexpr int kStages = 8;      // ring stages; stage s belongs to consumer s % kConsumers
constexpr int kRows = 32;       // cache rows a stage holds: one a producer lane
constexpr int kHeads = 8;       // q heads a CTA holds at most: A's rows 0..7
static_assert(kStages % kConsumers == 0, "a stage belongs to one consumer");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Arrive once and expect `bytes` more of copies on this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of the 4-D tensor map `map` at coordinates (c0, c1, c2, c3) into
// shared memory by the TMA engine, completing on `bar`; elements out of the
// tensor's bounds are written as zeros.  The cache is read once: its lines
// are the first L2 evicts.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], pol;\n}\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}
// c += A B for a 16x16 bf16 A whose rows 8..15 are zero (a1 = a3 = 0), a
// 16x8 bf16 B, float32 c.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of a CTA of the ring: kStages stages of a K tile then a V
// tile, each D / kBoxCols boxes of kRows rows by kBoxCols columns as the TMA
// engine writes them (swizzled in 16-byte chunks, so that the 8 rows an
// ldmatrix phase reads fall in 8 distinct bank groups), then the full and
// empty barriers.  The stages start on a 1024-byte boundary, the swizzle's
// period.  After the row loop the stages hold the consumers' partials.
template <int D>
struct Ring {
  static constexpr int kBoxCols = D < 64 ? D : 64;       // a box row: 32, 64 or 128 bytes
  static constexpr int kBoxRowBytes = kBoxCols * 2;
  static constexpr int kBoxBytes = kRows * kBoxRowBytes;  // a multiple of 1024
  static constexpr int kBoxes = D / kBoxCols;             // boxes a tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kBytes = 1024 + kBarOffset + 2 * kStages * 8;  // 1024: alignment slack
  static_assert(kBoxBytes % 1024 == 0, "boxes keep the swizzle's period");
  static_assert(kConsumers * kHeads * (D + 2) * 4 <= kBarOffset, "merge fits");
  // the byte of (row r, column d) of a tile: box, row, swizzled 16-byte chunk
  static __device__ __forceinline__ uint32_t at(int r, int d) {
    const uint32_t off = r * kBoxRowBytes + (d % kBoxCols) * 2;
    constexpr uint32_t kMask = kBoxRowBytes / 16 - 1;
    return (d / kBoxCols) * kBoxBytes + (off ^ (((off >> 7) & kMask) << 4));
  }
};

// Grid (splits, Hkv * head chunks, B), kConsumers + 1 warps a CTA.  tk and tv
// are K and V as 4-D tensor maps over (D, Hkv, S, B), boxes of
// (kBoxCols, 1, kRows, 1).
template <int D>
__global__ void __launch_bounds__((kConsumers + 1) * 32)
attend_mma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  Args a) {
  using R = Ring<D>;
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "D must be 16..128");
  const int Hg = a.Hq / a.Hkv;
  const int nchunks = (Hg + kHeads - 1) / kHeads;
  const int g = blockIdx.y / nchunks;
  const int h0 = g * Hg + (blockIdx.y % nchunks) * kHeads;  // first q head of the CTA
  const int nh = min(kHeads, (g + 1) * Hg - h0);
  const int b = blockIdx.z;
  const int s = blockIdx.x;
  const int len = min(max(a.pos[b], 0), a.S);
  const int lo = s * a.rows;
  const int hi = min(lo + a.rows, len);
  if (lo >= hi) return;  // a range past pos[b]: combine_kernel skips it
  const int ntiles = (hi - lo + kRows - 1) / kRows;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kBarOffset);
  uint64_t* empty = full + kStages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);   // the producer's arrive, plus the stage's bytes
      mbar_init(empty + i, 1);  // the consumer's arrive
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float m = -INFINITY, l = 0.f;
  float o[D / 8][4];
  if (warp == kConsumers) {
    // producer, one lane: tile i into stage i % kStages once its consumer
    // has released the tile kStages before.  A tile is kRows rows from
    // lo + i kRows; the last one of a range ends at hi instead, so that no
    // row at or past hi is read (rows before lo that it takes are rows of
    // the sequence below pos[b], or zeros before row 0)
    if (lane == 0) {
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + st, ((i / kStages) - 1) & 1);
        const int t0 = min(lo + i * kRows, hi - kRows);
        unsigned char* kd = ring + st * R::kStageBytes;
        mbar_arrive_tx(full + st, R::kStageBytes);
#pragma unroll
        for (int x = 0; x < R::kBoxes; ++x) {
          tma_load(kd + x * R::kBoxBytes, &tk, x * R::kBoxCols, g, t0, b, full + st);
          tma_load(kd + R::kTileBytes + x * R::kBoxBytes, &tv, x * R::kBoxCols, g, t0, b,
                   full + st);
        }
      }
    }
  } else {
    // consumer: q as the A operand, rows 0..7 the CTA's heads (kept in
    // registers, as given), rows 8..15 zero
    const int r = lane >> 2, c = lane & 3;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        static_cast<const __nv_bfloat16*>(a.q) + (static_cast<size_t>(b) * a.Hq + h0 + r) * D);
    uint32_t qa[D / 16][2];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = r < nh ? qrow[ks * 8 + c] : 0u;      // d 16 ks + 2c, +1
      qa[ks][1] = r < nh ? qrow[ks * 8 + 4 + c] : 0u;  // d 16 ks + 8 + 2c, +1
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    const float sl = a.scale * kLog2e;
    for (int i = warp; i < ntiles; i += kConsumers) {
      const int st = i % kStages;
      mbar_wait(full + st, (i / kStages) & 1);
      // the tile's rows below `first` were taken again or are zeros: masked
      const int first = max(0, lo + i * kRows - (hi - kRows));
      const uint32_t kt = smem_u32(ring + st * R::kStageBytes);
      const uint32_t vt = kt + R::kTileBytes;
      // S = Q K^T over the tile's rows: n-tile nt holds rows 8 nt .. 8 nt + 7
      float sc[kRows / 8][4];
#pragma unroll
      for (int nt = 0; nt < kRows / 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        const int row = nt * 8 + (lane & 7);
        if constexpr (D % 32 == 0) {
#pragma unroll
          for (int k2 = 0; k2 < D / 32; ++k2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(kt + R::at(row, k2 * 32 + (lane >> 3) * 8), b0, b1, b2, b3);
            mma16816(sc[nt], qa[2 * k2][0], qa[2 * k2][1], b0, b1);
            mma16816(sc[nt], qa[2 * k2 + 1][0], qa[2 * k2 + 1][1], b2, b3);
          }
        } else {
          uint32_t b0, b1;
          ldsm_x2(kt + R::at(row, ((lane >> 3) & 1) * 8), b0, b1);
          mma16816(sc[nt], qa[0][0], qa[0][1], b0, b1);
        }
      }
      // online softmax over the tile, row r of the lane's quad
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][e] = nt * 8 + 2 * c + e >= first ? sc[nt][e] * sl : -INFINITY;
          tmax = fmaxf(tmax, sc[nt][e]);
        }
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
      const float mn = fmaxf(m, tmax);  // finite: the tile's last row is valid
      const float corr = exp2f(m - mn);
      m = mn;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][e] = exp2f(sc[nt][e] - mn);
          psum += sc[nt][e];
        }
      }
      l = l * corr + psum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= corr;
        o[j][1] *= corr;
      }
      // O += P V: k-step kk takes the tile's rows 16 kk .. 16 kk + 15.  P is
      // bf16 hi + lo (two products, the second hidden behind the copies)
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        const uint32_t ph0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        const uint32_t ph2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        const uint32_t pl0 = pack_bf16(sc[2 * kk][0] - __uint_as_float(ph0 << 16),
                                       sc[2 * kk][1] - __uint_as_float(ph0 & 0xffff0000u));
        const uint32_t pl2 = pack_bf16(sc[2 * kk + 1][0] - __uint_as_float(ph2 << 16),
                                       sc[2 * kk + 1][1] - __uint_as_float(ph2 & 0xffff0000u));
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(vt + R::at(row, dp * 16 + (lane >> 4) * 8), b0, b1, b2, b3);
          mma16816(o[2 * dp], ph0, ph2, b0, b1);
          mma16816(o[2 * dp + 1], ph0, ph2, b2, b3);
          mma16816(o[2 * dp], pl0, pl2, b0, b1);
          mma16816(o[2 * dp + 1], pl0, pl2, b2, b3);
        }
      }
      __syncwarp();  // every lane is done with the stage
      if (lane == 0) mbar_arrive(empty + st);
    }
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
  }

  // merge the consumers through shared memory and write the CTA's partial
  __syncthreads();  // every tile is consumed: the stages are free
  float* sm_m = reinterpret_cast<float*>(ring);  // [kConsumers][kHeads]
  float* sm_l = sm_m + kConsumers * kHeads;      // [kConsumers][kHeads]
  float* sm_acc = sm_l + kConsumers * kHeads;    // [kConsumers][kHeads][D]
  if (warp < kConsumers) {
    const int r = lane >> 2, c = lane & 3;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      sm_acc[(warp * kHeads + r) * D + j * 8 + 2 * c] = o[j][0];
      sm_acc[(warp * kHeads + r) * D + j * 8 + 2 * c + 1] = o[j][1];
    }
    if (c == 0) {
      sm_m[warp * kHeads + r] = m;
      sm_l[warp * kHeads + r] = l;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += blockDim.x) {
    const int h = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) M = fmaxf(M, sm_m[w * kHeads + h]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float mw = sm_m[w * kHeads + h];
      if (mw == -INFINITY) continue;  // a consumer with no tile
      const float cw = exp2f(mw - M);
      Ls += sm_l[w * kHeads + h] * cw;
      A += sm_acc[(w * kHeads + h) * D + d] * cw;
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

// Launch attend_kernel and combine_kernel for `a`, or, with `occupancy` set,
// write there how many attention CTAs an SM holds at once and launch nothing.
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

// cuTensorMapEncodeTiled, reached through the CUDA runtime's entry-point
// lookup, so that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// K or V (B, S, Hkv, D) in bfloat16 as a 4-D tensor map over (D, Hkv, S, B),
// boxes of (cols, 1, kRows, 1), swizzled by the box row's 32, 64 or 128 bytes.
cudaError_t make_map(CUtensorMap* map, const void* base, const Args& a, int D, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(a.Hkv),
                              static_cast<cuuint64_t>(a.S), static_cast<cuuint64_t>(a.B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * a.Hkv, row * a.Hkv * a.S};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, kRows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t run_mma(const Args& a, cudaStream_t stream, int* occupancy) {
  constexpr int smem = Ring<D>::kBytes;
  constexpr int threads = (kConsumers + 1) * 32;
  cudaError_t err = cudaFuncSetAttribute(attend_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, attend_mma_kernel<D>,
                                                         threads, smem);
  CUtensorMap tk, tv;
  err = make_map(&tk, a.k, a, D, Ring<D>::kBoxCols);
  if (err == cudaSuccess) err = make_map(&tv, a.v, a, D, Ring<D>::kBoxCols);
  if (err != cudaSuccess) return err;
  const int nchunks = (a.Hq / a.Hkv + kHeads - 1) / kHeads;
  attend_mma_kernel<D>
      <<<dim3(a.splits, a.Hkv * nchunks, a.B), threads, smem, stream>>>(tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<__nv_bfloat16><<<dim3(a.Hq, a.B), D, 0, stream>>>(a, D);
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

cudaError_t run_dtype(const Args& a, int dtype, int D, cudaStream_t stream, int* occupancy) {
  if (dtype == 0) {
    switch (D) {
      case 8: return run_ht<float, 8>(a, stream, occupancy);
      case 16: return run_ht<float, 16>(a, stream, occupancy);
      case 32: return run_ht<float, 32>(a, stream, occupancy);
      case 64: return run_ht<float, 64>(a, stream, occupancy);
      case 128: return run_ht<float, 128>(a, stream, occupancy);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 8: return run_ht<__nv_bfloat16, 8>(a, stream, occupancy);
      case 16: return run_mma<16>(a, stream, occupancy);
      case 32: return run_mma<32>(a, stream, occupancy);
      case 64: return run_mma<64>(a, stream, occupancy);
      case 128: return run_mma<128>(a, stream, occupancy);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
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

// The tensor-core kernel's ring: stages, cache rows a stage, consumer warps
// (plus one producer warp) and q heads a CTA.
extern "C" void decode_attention_ring(int* stages, int* rows, int* consumers, int* heads) {
  *stages = kStages;
  *rows = kRows;
  *consumers = kConsumers;
  *heads = kHeads;
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
