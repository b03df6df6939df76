// K3: flash-attention forward for Hopper (sm_90a), GQA-grouped, with
// causal and sliding-window masks taken from position arrays.
//
// Replaces the Pallas TPU kernel _flash_kernel / flash_attention
// (src/repro/kernels/flash_attention.py), reached from
// multihead_attention(impl="pallas") in the prefill path.
//
//   q (B, Sq, KVH, G, D), k/v (B, Sk, KVH, D), qpos (B, Sq), kpos (B, Sk)
//   int32; out (B, Sq, KVH, G, D) in q's dtype.  bfloat16: D in {64, 128,
//   224, 256}; float32: D in {16, 32, 64, 128}.
//
// What bounds it: operations, 4 * D * (query head, key) pairs the mask lets
// through, far above the card's 295 operations per byte.  Three things keep
// a straightforward tensor-core kernel far from that bound (1.88 ms, 12x
// it, against SDPA's 0.52 for a 1024-query split behind 4096 cache keys,
// on an NVIDIA H100 80GB HBM3 at 700 W), and the design answers each:
//   * visiting every key of Sk, though on the serving path most are
//     hidden: a fresh request's legacy cache slot is empty (kpos -1) and
//     the causal mask hides the upper half of the chunk's own keys.  The
//     wrapper's live-tile table (kernels/flash_attention.py live_tiles,
//     the one place the rule lives) marks each (q tile, key tile) 0
//     (every pair hidden: skipped), 1 (visited and masked) or 2 (every pair
//     visible: visited without the mask).  The producer and the consumers
//     walk the same live tiles in the same order.
//   * few rows per CTA: with 64 query rows, every K/V tile a CTA streams
//     serves 64 rows.  A CTA holds 128 (qt = 128 / G queries x the G heads
//     of the group), in two consumer warpgroups.
//   * loads and mma.sync taking turns on the same threads.  A producer
//     warp keeps kStages K/V tiles in flight with TMA (tensor maps over
//     (D, KVH, Sk, B), 128-byte swizzle, completion on mbarriers), and the
//     consumers run wgmma: S = Q K^T with both operands in shared memory
//     (K-major), O += P V with P in registers and V read through the
//     descriptor's transpose bit.  The two warpgroups take turns to issue
//     their products (named barriers) so one's softmax runs under the
//     other's wgmmas.  The producer warpgroup gives its registers to the
//     consumers (setmaxnreg 24 / 240).
// Measured (chip_smoke.py, the same card): 0.35 ms for that split, the
// live-tile table and the side pass included; the main path's first
// prefill split, behind an empty 4096-slot row, visits 11 % of its key
// tiles and takes 0.15 ms.
//
// Head dims above 128 (gemma3's 256, the 224 of zamba2's shared 2d-wide
// attention) hit the SM's limits: a 128-row Q tile and two stages of
// 128-key K/V tiles at D = 256 would need 320 KB of shared memory against
// 227 KB, and the fp32 O accumulator of a 64-row warpgroup is D / 2
// registers a thread.  So above 128 the K/V tiles hold 64 keys (Q 64 KB
// plus two stages of K and V, 128 KB), which also halves S (32 registers)
// and P's fragments (16), leaving the 128 of O within the consumers' 240.
// D = 224 runs as D = 256 with the head dim's last 32 columns zero: the
// tensor maps end at D, so TMA fills the last 64-column box's tail with
// zeros, which add nothing to Q K^T and make O's tail columns zero, and
// the epilogue stores the first D columns only.
//
// Numerics traps, all as the model path's _attn_ref
// (src/repro/layers/attention.py):
//   * masked logits are the FINITE NEG_INF = -0.7 * FLT_MAX, not -inf.  A
//     query row with no visible key (a padded prefill token, qpos = -1)
//     therefore gets the uniform average of V over all Sk keys -- not NaN
//     and not 0.  The unskipped online softmax reproduces this exactly:
//     while every key seen is masked, m = NEG_INF and each masked key adds
//     exp(0) = 1; the first visible key makes the correction
//     exp(NEG_INF - m) = 0.  (kernels/ref.flash_attention_ref uses -inf and
//     zeroes NaNs instead; this kernel does not follow it.)
//   * skipping keeps that rule by a side pass: a row whose running max is
//     still NEG_INF after its live tiles has seen no visible key, and takes
//     mean(V) over all Sk keys of its KV head in fp32, from per-chunk column
//     sums of V (vsum_kernel, launched before the main kernel in the same
//     call; it reads V once).  For rows with a visible key, skipping a tile
//     of hidden keys drops only terms that would be exactly 0.
//   * keys past Sk in the last tile are not keys at all: their logit is
//     -inf, so they add nothing even to a fully masked row.  Padding keys
//     inside Sk carry kpos = -1 and are masked like any other.
//   * the output divides by max(l, 1e-30).
// The float32 body (plain FMA, for the small-model identity checks) visits
// every key and needs neither the table nor the side pass.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows per CTA (q tile * G)
constexpr int kKeys = 64;     // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr int kPastEnd = INT_MIN;  // kpos marker for keys beyond Sk

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * (D + 1)      // Q
                          + kKeys * (D + 1)    // K
                          + kKeys * D          // V
                          + kRows * (kKeys + 1)  // S, then P
                          + 3 * kRows)         // m, l, correction
         + sizeof(int) * (kRows + kKeys);      // qpos, kpos
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, float* __restrict__ out, int Sq,
                 int Sk, int KVH, int G, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kRows][D + 1]
  float* Ks = Qs + kRows * (D + 1);        // [kKeys][D + 1]
  float* Vs = Ks + kKeys * (D + 1);        // [kKeys][D]
  float* Ps = Vs + kKeys * D;              // [kRows][kKeys + 1]
  float* m_s = Ps + kRows * (kKeys + 1);
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;
  int* qp_s = reinterpret_cast<int*>(c_s + kRows);
  int* kp_s = qp_s + kRows;

  const int b = blockIdx.z, h = blockIdx.y;
  const int qt = kRows / G;                // queries per CTA
  const int q0 = blockIdx.x * qt;
  const int nrows = qt * G;
  const int tid = threadIdx.x;

  // row r of the tile is query q0 + r / G, group r % G
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, qi = q0 + r / G;
    float val = 0.f;
    if (r < nrows && qi < Sq)
      val = q[((((int64_t)b * Sq + qi) * KVH + h) * G + r % G) * D + d];
    Qs[r * (D + 1) + d] = val;
  }
  if (tid < kRows) {
    const int qi = q0 + tid / G;
    qp_s[tid] = (tid < nrows && qi < Sq) ? qpos[(int64_t)b * Sq + qi] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int ty = tid >> 4, tx = tid & 15;  // rows ty*4.., keys/dims tx + 16 i
  constexpr int kDpt = D / 16;
  float acc[4][kDpt];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[a][i] = 0.f;
  const int warp = tid >> 5, lane = tid & 31;

  for (int k0 = 0; k0 < Sk; k0 += kKeys) {
    __syncthreads();  // previous tile's K, V, P fully consumed
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        const int64_t off = (((int64_t)b * Sk + key) * KVH + h) * D + d;
        kv = k[off];
        vv = v[off];
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * D + d] = vv;
    }
    if (tid < kKeys) {
      const int key = k0 + tid;
      kp_s[tid] = key < Sk ? kpos[(int64_t)b * Sk + key] : kPastEnd;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4 + a, keys tx + 16 c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty * 4 + a) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = Ks[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, qp = qp_s[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c, kp = kp_s[j];
        float val;
        if (kp == kPastEnd) {
          val = -INFINITY;
        } else {
          bool ok = kp >= 0;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && (qp - kp) < window;
          val = ok ? s[a][c] * sm_scale : kNegInf;
        }
        Ps[r * (kKeys + 1) + j] = val;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, two keys per lane
#pragma unroll
    for (int rr = 0; rr < kRows / 8; ++rr) {
      const int r = warp * (kRows / 8) + rr;
      float* pr = Ps + r * (kKeys + 1);
      const float a0 = pr[lane], a1 = pr[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a0, a1)));
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty*4 + a, dims tx + 16 i
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float cr = c_s[ty * 4 + a];
#pragma unroll
      for (int i = 0; i < kDpt; ++i) acc[a][i] *= cr;
    }
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty * 4 + a) * (kKeys + 1) + j];
#pragma unroll
      for (int i = 0; i < kDpt; ++i) {
        const float vv = Vs[j * D + tx + 16 * i];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][i] = fmaf(pa[a], vv, acc[a][i]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a, qi = q0 + r / G;
    if (r < nrows && qi < Sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      float* orow = out + ((((int64_t)b * Sq + qi) * KVH + h) * G + r % G) * D;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) orow[tx + 16 * i] = acc[a][i] / l;
    }
  }
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the side pass: V's column sums per chunk of keys ---------------------
//
// vsum[b][h][c][d] = sum of v[b, key, h, d] over the c-th chunk of
// kVsumKeys keys, in fp32.  A query row with no visible key takes
// (sum over c) / Sk: the uniform average of V over all Sk keys, which the
// unskipped online softmax gave it and the skipped one no longer can.
constexpr int kVsumKeys = 256;
constexpr int kVsumThreads = 128;

template <int D>
__global__ void __launch_bounds__(kVsumThreads)
vsum_kernel(const __nv_bfloat16* __restrict__ v, float* __restrict__ vsum,
            int Sk, int KVH) {
  constexpr int TPK = D / 8;                  // threads per key, 16 B each
  constexpr int KPP = kVsumThreads / TPK;     // keys per pass (D = 224: 4,
                                              // threads 112.. stay idle)
  __shared__ float red[KPP][D];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tk = threadIdx.x / TPK, c8 = (threadIdx.x % TPK) * 8;
  if (tk < KPP) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    const int k_end = min(Sk, (c + 1) * kVsumKeys);
#pragma unroll 4
    for (int key = c * kVsumKeys + tk; key < k_end; key += KPP) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          v + (((int64_t)b * Sk + key) * KVH + h) * D + c8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += __bfloat162float(e[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[tk][c8 + j] = acc[j];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kVsumThreads) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < KPP; ++r) s += red[r][d];
    vsum[(((int64_t)b * KVH + h) * gridDim.x + c) * D + d] = s;
  }
}

// Write the mean of V (from the side pass's partials) into this thread's
// columns n * 8 + 2t, +1 of a bf16 output row: the accumulator layout's.
template <int D>
__device__ __forceinline__ void store_mean_v(__nv_bfloat16* orow,
                                             const float* part, int n_chunks,
                                             int Sk, int t) {
  const float inv = 1.f / static_cast<float>(Sk);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      s0 += part[c * D + col];
      s1 += part[c * D + col + 1];
    }
    *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(s0 * inv, s1 * inv);
  }
}

// ---- bfloat16 body: TMA + wgmma, warp-specialised --------------------------
//
// One CTA per (KV head, q tile, batch): kTcRows = 128 query rows (qt = 128 / G
// queries x G heads of the group), held by two consumer warpgroups of 64
// rows each, and a producer warpgroup of which one warp loads.  The producer walks the CTA's live key
// tiles (the wrapper's table) and keeps kStages K/V tiles of tc_keys(D) keys in
// flight with TMA, each stage completing on an mbarrier ("full"); the
// consumers hand a stage back on a second mbarrier ("empty") once both
// products have read it.  Per tile and warpgroup:
//   S = Q K^T   wgmma m64nKk16, Q and K from shared memory, both K-major;
//   online softmax on S in registers (mask from positions, fp32 m and l);
//   O += P V    wgmma m64nDPk16, P from registers (S rounded to bf16, the
//               accumulator layout reused as A fragments), V from shared
//               memory through the descriptor's transpose bit (MN-major).
// Every tile is loaded with a 128-byte swizzle: rows of 64 bf16 (128 B), one
// box per 64 columns of the head dim, so a D = 128 tile is two column
// blocks and DP, the head dim rounded up to 64, is what the products span.
// Rows past qt * G, keys past Sk and columns past D are zero-filled or
// ignored.

constexpr int kTcRows = 128;     // query rows per CTA (q tile * G)
// keys per K/V tile: 128, or 64 above D = 128 (shared memory, registers)
__host__ __device__ constexpr int tc_keys(int D) { return D > 128 ? 64 : 128; }
constexpr int kStages = 2;
constexpr int kConsumers = 256;  // two warpgroups
// and a producer warpgroup, of which one warp works: registers are
// allocated per warpgroup, and the producer hands its share to the
// consumers (setmaxnreg: 24 each for the producer, 240 for a consumer)
constexpr int kTcThreads = kConsumers + 128;
constexpr int kQBlockBytes = kTcRows * 128;  // 128 rows x 64 bf16: one Q box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Spin until the phase of the given parity has completed.  A wait that
// outlasts ~2^30 tries (seconds) traps: a lost arrival becomes a launch
// error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo: bytes between
// swizzle atoms along the leading (MN) dimension of an MN-major operand
// (unused for K-major); sbo: bytes between groups of 8 rows (K-major) or of
// 8 k-rows (MN-major), 1024 for 128-byte rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// 2^x, the SFU's approximation (2 ulp; 0 for -inf and for x < -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin accumulator registers around an asynchronous wgmma so the compiler
// neither reads them early nor moves writes past the fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128) (+)= A (64 x 16, shared, K-major) * B (128 x 16, shared,
// K-major)^T; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) (+)= A (64 x 16, shared, K-major) * B (64 x 16, shared,
// K-major)^T; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major:
// the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128_t(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major:
// the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256) += A (64 x 16, registers) * B (16 x 256, shared, MN-major:
// the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n256_t(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 256) wgmma_rs_n256_t(o, a, db);
  else if constexpr (DP == 128) wgmma_rs_n128_t(o, a, db);
  else wgmma_rs_n64_t(o, a, db);
}

template <int K>
__device__ __forceinline__ void wgmma_qk(float (&s)[K / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (K == 128) wgmma_ss_n128(s, da, db, scale_d);
  else wgmma_ss_n64(s, da, db, scale_d);
}

// S = Q K^T over the head dim's D columns, 16 at a time (a zero-filled
// tail past D needs none): q_rows is this warpgroup's 64 rows of the Q
// tile, k the K tile of K keys; each one's 64-column blocks are one box
// apart.
template <int D, int K>
__device__ __forceinline__ void tc_issue_s(float (&s)[K / 2], uint32_t q_rows,
                                           uint32_t k) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_qk<K>(s, sw128_desc(q_rows + (kk >> 2) * kQBlockBytes + col, 16, 1024),
                sw128_desc(k + (kk >> 2) * K * 128 + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: V's k-rows (keys) are 128 bytes apart, its column blocks (64
// dims) K * 128 bytes apart.
template <int DP, int K>
__device__ __forceinline__ void tc_issue_pv(float (&o)[DP / 2],
                                            const uint32_t (&pa)[K / 16][4],
                                            uint32_t v) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_pv<DP>(o, pa[kk], sw128_desc(v + kk * 16 * 128, K * 128, 1024));
  wgmma_commit();
}

// Online softmax of S in place, in the log2 domain: c = sm_scale * log2(e),
// m is the running max of c * S (masked logits at the finite kNegInf, keys
// past Sk at -inf), p = 2^(c S - m), corr = 2^(m_old - m) is each row's
// correction of O.  A full tile (every pair visible) skips the mask and
// takes its max on S before scaling (c > 0, so the max commutes).  A row
// lives in the 4 lanes of a quad; kp holds the tile's key positions.
template <bool full, int K>
__device__ __forceinline__ void tc_softmax(float (&s)[K / 2], float (&m)[2],
                                           float (&l)[2], const int (&qp)[2],
                                           const int* kp, int t, int causal,
                                           int window, float c, float (&corr)[2]) {
  float mx[2];
  if constexpr (full) {
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < K / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = fmaxf(m[i], mx[i] * c);
  } else {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int n = 0; n < K / 8; ++n) {
      const int2 kp2 = *reinterpret_cast<const int2*>(kp + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kpv = (e & 1) ? kp2.y : kp2.x;
        float val;
        if (kpv == kPastEnd) {
          val = -INFINITY;
        } else {
          bool ok = kpv >= 0;
          if (causal) ok = ok && qp[i] >= kpv;
          if (window > 0) ok = ok && (qp[i] - kpv) < window;
          val = ok ? s[4 * n + e] * c : kNegInf;
        }
        s[4 * n + e] = val;
        mx[i] = fmaxf(mx[i], val);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
  }
  if constexpr (full) {
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      const int i = (j >> 1) & 1;
      s[j] = ex2(fmaf(s[j], c, -m[i]));
      sum[i] += s[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      const int i = (j >> 1) & 1;
      s[j] = ex2(s[j] - m[i]);
      sum[i] += s[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * corr[i] + sum[i];
  }
}

// O *= corr, then P's accumulator fragments become A fragments (rounded to
// bf16), 16 keys per k-step.
template <int DP, int K>
__device__ __forceinline__ void tc_rescale_pack(float (&o)[DP / 2],
                                                const float (&s)[K / 2],
                                                uint32_t (&pa)[K / 16][4],
                                                const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    o[4 * n + 0] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
constexpr int tc_smem_bytes() {
  constexpr int CB = (D + 63) / 64, K = tc_keys(D);
  return 1024                                       // alignment slack
         + CB * kQBlockBytes                        // Q
         + kStages * 2 * CB * K * 128               // K and V stages
         + kStages * K * 4                          // key positions
         + (1 + 2 * kStages) * 8;                   // mbarriers
}
static_assert(tc_smem_bytes<256>() <= 232448, "D = 256 tiles exceed 227 KB");

// Accumulator layout of wgmma m64nN (f32), per warpgroup: warp w, lane
// l = 4 g + t holds rows 16 w + g (elements 4 i + 0, 1) and 16 w + g + 8
// (4 i + 2, 3), columns 8 i + 2 t and + 1.  A fragments in registers use
// the same rows and, for k-step kk, columns 16 kk + 2 t (+1) and + 8.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const int* __restrict__ qpos, const int* __restrict__ kpos,
                    __nv_bfloat16* __restrict__ out,
                    const uint8_t* __restrict__ live,
                    const float* __restrict__ vsum, int Sq, int Sk, int KVH, int G,
                    int causal, int window, int n_kt, int n_chunks,
                    float sm_scale) {
  constexpr int CB = (D + 63) / 64;          // column blocks of the head dim
  constexpr int DP = CB * 64;                // the head dim the products span
  constexpr int K = tc_keys(D);              // keys per K/V tile
  constexpr int kTileBytes = CB * K * 128;   // one K or V tile
  constexpr int kQBytes = CB * kQBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + kQBytes;       // stage s: K at +2s, V at +2s+1
  int* kp_s = reinterpret_cast<int*>(smem + kQBytes + 2 * kStages * kTileBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(kp_s + kStages * K);
  const uint32_t bar_q = smem_u32(bars);
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int qtile = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int qt = kTcRows / G, q0 = qtile * qt, nrows = qt * G;
  const uint8_t* lrow = live + ((int64_t)b * gridDim.y + qtile) * n_kt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);                  // the producer's lanes
      mbar_init(bar_empty + 8 * s, kConsumers / 32);    // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform role indices (a shuffle the compiler can see is uniform):
  // setmaxnreg's register budgets apply only to branches it can prove
  // never diverge within a warp
  const int wg_idx = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp_idx = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (wg_idx == kConsumers / 128) {
    // ---- producer warpgroup: its first warp loads, the others leave ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp_idx != kConsumers / 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_arrive_tx(bar_q, CB * nrows * 128);
      for (int c = 0; c < CB; ++c)
        tma_load_5d(s_q + c * kQBlockBytes, &tm_q, bar_q, c * 64, 0, h, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (!lrow[kt]) continue;
      mbar_wait(bar_empty + 8 * stage, phase ^ 1);
      for (int j = lane; j < K; j += 32) {
        const int key = kt * K + j;
        kp_s[stage * K + j] = key < Sk ? kpos[(int64_t)b * Sk + key] : kPastEnd;
      }
      const uint32_t full = bar_full + 8 * stage;
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * kTileBytes);
        const uint32_t dk = s_kv + 2 * stage * kTileBytes;
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(dk + c * K * 128, &tm_k, full, c * 64, h, kt * K, b);
          tma_load_4d(dk + kTileBytes + c * K * 128, &tm_v, full, c * 64, h, kt * K, b);
        }
      } else {
        mbar_arrive(full);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = wg_idx, warp = warp_idx & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int qp[2];
  bool valid[2];
  int64_t orow_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * 64 + warp * 16 + g + 8 * i, qi = q0 + r / G;
    valid[i] = r < nrows && qi < Sq;
    qp[i] = valid[i] ? qpos[(int64_t)b * Sq + qi] : -1;
    orow_off[i] = ((((int64_t)b * Sq + qi) * KVH + h) * G + r % G) * D;
  }
  float o[DP / 2], s[K / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < K / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float c = sm_scale * 1.4426950408889634f;  // log2(e)
  const uint32_t q_rows = s_q + wg * 64 * 128;   // this warpgroup's 64 rows

  uint32_t pa[K / 16][4];
  auto next_live = [&](int kt) {
    for (++kt; kt < n_kt && !lrow[kt]; ++kt) {
    }
    return kt;
  };
  auto wait_full = [&](int it) {
    mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
  };
  auto tile_k = [&](int st) { return s_kv + 2 * st * kTileBytes; };
  auto tile_v = [&](int st) { return s_kv + (2 * st + 1) * kTileBytes; };
  auto tile_kp = [&](int st) { return kp_s + st * K; };

  mbar_wait(bar_q, 0);
  __syncwarp();
  // The live tiles in order; the i-th sits in stage i % kStages and goes
  // back to the producer once both products have read it.  The two
  // warpgroups take turns to issue their products (named barriers 1 and
  // 2, FA3's ping-pong): while one warpgroup's wgmmas run on the tensor
  // cores, the other does its softmax.  Warpgroup 1 lets 0 go first.
  if (wg == 1) named_arrive(1, kConsumers);
  for (int kt = next_live(-1), it = 0; kt < n_kt; kt = next_live(kt), ++it) {
    const int st = it % kStages;
    float corr[2];
    wait_full(it);
    named_sync(1 + wg, kConsumers);
    tc_issue_s<D, K>(s, q_rows, tile_k(st));
    named_arrive(2 - wg, kConsumers);
    wgmma_wait<0>();
    fence_regs(s);
    if (lrow[kt] == 2)
      tc_softmax<true, K>(s, m, l, qp, nullptr, t, causal, window, c, corr);
    else
      tc_softmax<false, K>(s, m, l, qp, tile_kp(st), t, causal, window, c, corr);
    tc_rescale_pack<DP, K>(o, s, pa, corr);
    named_sync(1 + wg, kConsumers);
    tc_issue_pv<DP, K>(o, pa, tile_v(st));
    named_arrive(2 - wg, kConsumers);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    __nv_bfloat16* orow = out + orow_off[i];
    if (m[i] == kNegInf) {  // no visible key: the mean of V over all Sk
      store_mean_v<D>(orow, vsum + ((int64_t)b * KVH + h) * n_chunks * D,
                      n_chunks, Sk, t);
      continue;
    }
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(o[4 * n + 2 * i] / li, o[4 * n + 2 * i + 1] / li);
  }
}

// ---- tensor maps --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda at link time).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with a 128-byte swizzle; dims and box innermost first,
// strides in bytes for dims 1.. .
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- launchers --------------------------------------------------------------

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const int* qpos,
                       const int* kpos, void* out, int B, int Sq, int Sk, int KVH,
                       int G, int causal, int window, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_fwd_fma_kernel<D>;
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int qt = kRows / G;
  dim3 grid((Sq + qt - 1) / qt, KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qpos, kpos, static_cast<float*>(out), Sq, Sk,
      KVH, G, causal, window, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* qpos,
                      const int* kpos, void* out, const uint8_t* live, float* vsum,
                      int B, int Sq, int Sk, int KVH, int G, int causal, int window,
                      int n_kt, float sm_scale, cudaStream_t stream) {
  const int n_chunks = (Sk + kVsumKeys - 1) / kVsumKeys;
  vsum_kernel<D><<<dim3(n_chunks, KVH, B), kVsumThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(v), vsum, Sk, KVH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // q (B, Sq, KVH, G, D): a box of qt queries x G heads x 64 columns;
  // k, v (B, Sk, KVH, D): a box of tc_keys(D) keys x 64 columns
  const int qt = kTcRows / G;
  const cuuint64_t el = sizeof(__nv_bfloat16);
  const cuuint64_t qdims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)KVH,
                               (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstr[4] = {D * el, (cuuint64_t)G * D * el,
                              (cuuint64_t)KVH * G * D * el,
                              (cuuint64_t)Sq * KVH * G * D * el};
  const cuuint32_t qbox[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)qt, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)Sk,
                               (cuuint64_t)B};
  const cuuint64_t kstr[3] = {D * el, (cuuint64_t)KVH * D * el,
                              (cuuint64_t)Sk * KVH * D * el};
  const cuuint32_t kbox[4] = {64, 1, (cuuint32_t)tc_keys(D), 1};
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, 5, qdims, qstr, qbox) ||
      !make_map(&tm_k, k, 4, kdims, kstr, kbox) ||
      !make_map(&tm_v, v, 4, kdims, kstr, kbox))
    return cudaErrorInvalidValue;

  auto kernel = flash_fwd_tc_kernel<D>;
  constexpr int smem = tc_smem_bytes<D>();
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(KVH, (Sq + qt - 1) / qt, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, qpos, kpos, static_cast<__nv_bfloat16*>(out), live, vsum, Sq,
      Sk, KVH, G, causal, window, n_kt, n_chunks, sm_scale);
  return cudaGetLastError();
}

#define FLASH_ARGS q, k, v, qp, kp, out, B, Sq, Sk, KVH, G, causal, window, sm_scale, s
#define TC_ARGS q, k, v, qp, kp, out, lv, vs, B, Sq, Sk, KVH, G, causal, window, \
    n_kt, sm_scale, s

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA body, D in {16, 32, 64, 128}, every key visited),
// 1 = bfloat16 (TMA + wgmma body, D in {64, 128, 224, 256}, only the key
// tiles that live marks: (B, ceil(Sq / (kTcRows / G)), n_kt) bytes, n_kt =
// ceil(Sk / tc_keys(D)); vsum: B * KVH * ceil(Sk / kVsumKeys) * D floats of
// scratch for the side pass; flash_attention_tiling gives the three).
// q, k, v and out all of dtype.  Requires 1 <= G <= 64, Sq >= 1, Sk >= 1;
// for bfloat16 also q, k and v 16-byte aligned and out 4-byte aligned.
// Returns cudaGetLastError() after the launches.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kpos, void* out,
                        const void* live, void* vsum, int B, int Sq, int Sk,
                        int KVH, int G, int D, int causal, int window, int n_kt,
                        float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kRows || Sq < 1 || Sk < 1 || B < 1 || KVH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  float* vs = static_cast<float*>(vsum);
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_fma<16>(FLASH_ARGS);
      case 32: return launch_fma<32>(FLASH_ARGS);
      case 64: return launch_fma<64>(FLASH_ARGS);
      case 128: return launch_fma<128>(FLASH_ARGS);
    }
  } else if (dtype == 1 && lv != nullptr && vs != nullptr &&
             n_kt == (Sk + tc_keys(D) - 1) / tc_keys(D)) {
    switch (D) {
      case 64: return launch_tc<64>(TC_ARGS);
      case 128: return launch_tc<128>(TC_ARGS);
      case 224: return launch_tc<224>(TC_ARGS);
      case 256: return launch_tc<256>(TC_ARGS);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 body's tiling at head dim D, which the wrapper reads: query
// rows per CTA and keys per K/V tile (its live-tile table) and keys per
// chunk of the side pass over V (its vsum scratch).
void flash_attention_tiling(int D, int* rows, int* keys, int* vsum_keys) {
  *rows = kTcRows;
  *keys = tc_keys(D);
  *vsum_keys = kVsumKeys;
}

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
