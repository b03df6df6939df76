// K3: flash-attention forward for Hopper (sm_90a), GQA-grouped, with
// causal and sliding-window masks taken from position arrays.
//
// Replaces the Pallas TPU kernel _flash_kernel / flash_attention
// (src/repro/kernels/flash_attention.py), reached from
// multihead_attention(impl="pallas") in the prefill path.
//
//   q (B, Sq, KVH, G, D), k/v (B, Sk, KVH, D), qpos (B, Sq), kpos (B, Sk)
//   int32; out (B, Sq, KVH, G, D) in q's dtype.  D in {16, 32, 64, 128}.
//
// What bounds it: operations.  4 * B * Sq * Sk * KVH * G * D FLOPs against
// (q + k + v + out) bytes puts prefill far above the card's 295 operations
// per byte.  The Pallas blocks do not carry over: their (512, G, D) fp32
// accumulator is 2 MiB, far beyond a CTA's 227 KB of shared memory.
// Design (simple and right first): one CTA per (batch, KV head, q tile of
// 64 / G queries), so the tile holds 64 query rows and one K/V tile of 64
// keys in shared memory serves all G query heads of the group; running
// max m, sum l and the output accumulator in fp32; no tile is skipped,
// every key of Sk is visited (see the first trap).  Two bodies, chosen by
// dtype:
//   * bfloat16 (the serving path): tensor cores through mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate), 4 warps of 16 query rows each.
//     Q stays in registers as A fragments; K is staged row-major and V
//     transposed in shared memory, so every B fragment is one 32-bit
//     load; P goes from the S accumulators to A fragments in registers
//     (rounded to bf16, as flash attention does).
//   * float32 (the small-model identity checks): plain FMA, 256 threads,
//     4 x 4 and 4 x (D / 16) register blocks, tiles staged as fp32.
// A wgmma/TMA pipeline with double-buffered tiles is the later PR that
// makes it fast.
//
// Numerics traps, all as the model path's _attn_ref
// (src/repro/layers/attention.py):
//   * masked logits are the FINITE NEG_INF = -0.7 * FLT_MAX, not -inf.  A
//     query row with no visible key (a padded prefill token, qpos = -1)
//     therefore gets the uniform average of V over all Sk keys — not NaN
//     and not 0.  The online softmax reproduces this exactly: while every
//     key seen is masked, m = NEG_INF and each masked key adds exp(0) = 1;
//     the first visible key makes the correction exp(NEG_INF - m) = 0.
//     (kernels/ref.flash_attention_ref uses -inf and zeroes NaNs instead;
//     this kernel does not follow it.)
//   * keys past Sk in the last tile are not keys at all: their logit is
//     -inf, so they add nothing even to a fully masked row.  Padding keys
//     inside Sk carry kpos = -1 and are masked like any other.
//   * the output divides by max(l, 1e-30).
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

// ---- bfloat16 body: tensor cores through mma.sync ------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16 x 16, row): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] =
//                     (g, 2t+8..), a[3] = (g+8, 2t+8..)
//   B (16 x 8, col):  b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g)
//   C (16 x 8):       c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ qpos, const int* __restrict__ kpos,
                     __nv_bfloat16* __restrict__ out, int Sq, int Sk, int KVH,
                     int G, int causal, int window, float sm_scale) {
  constexpr int KS = D + 8;       // K row stride: conflict-free B loads
  constexpr int VS = kKeys + 8;   // V^T row stride
  constexpr int KD = D / 16;      // k-steps over the head dim
  constexpr int ND = D / 8;       // n-tiles over the head dim
  constexpr int NK = kKeys / 8;   // n-tiles over the keys of a tile
  __shared__ __align__(16) __nv_bfloat16 Ks[kKeys * KS];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VS];
  __shared__ int kp_s[kKeys];

  const int b = blockIdx.z, h = blockIdx.y;
  const int qt = kRows / G, q0 = blockIdx.x * qt, nrows = qt * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // this thread's two rows of the tile: warp*16 + g and + 8
  int qp[2];
  bool valid[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i, qi = q0 + r / G;
    valid[i] = r < nrows && qi < Sq;
    qp[i] = valid[i] ? qpos[(int64_t)b * Sq + qi] : -1;
    qrow[i] = q + ((((int64_t)b * Sq + (valid[i] ? qi : 0)) * KVH + h) * G
                   + r % G) * D;
  }
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = valid[0] ? ld32(qrow[0] + c) : 0u;
    qa[kk][1] = valid[1] ? ld32(qrow[1] + c) : 0u;
    qa[kk][2] = valid[0] ? ld32(qrow[0] + c + 8) : 0u;
    qa[kk][3] = valid[1] ? ld32(qrow[1] + c + 8) : 0u;
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Sk; k0 += kKeys) {
    __syncthreads();  // the previous tile is fully consumed
    // K row-major, 16-byte vectors, lanes along the head dim (coalesced)
#pragma unroll
    for (int it = 0; it < kKeys * ND / kMmaThreads; ++it) {
      const int idx = tid + it * kMmaThreads;
      const int j = idx / ND, c8 = (idx % ND) * 8, key = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (key < Sk)
        kv = *reinterpret_cast<const uint4*>(
            k + (((int64_t)b * Sk + key) * KVH + h) * D + c8);
      *reinterpret_cast<uint4*>(&Ks[j * KS + c8]) = kv;
    }
    // V transposed, lanes along the keys (conflict-free 16-bit stores)
#pragma unroll
    for (int it = 0; it < kKeys * ND / kMmaThreads; ++it) {
      const int idx = tid + it * kMmaThreads;
      const int j = idx % kKeys, c8 = (idx / kKeys) * 8, key = k0 + j;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < Sk)
        vv = *reinterpret_cast<const uint4*>(
            v + (((int64_t)b * Sk + key) * KVH + h) * D + c8);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c8 + e) * VS + j] = ve[e];
    }
    if (tid < kKeys)
      kp_s[tid] = k0 + tid < Sk ? kpos[(int64_t)b * Sk + k0 + tid] : kPastEnd;
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const __nv_bfloat16* kr = &Ks[(j * 8 + g) * KS + kk * 16 + 2 * t];
        const uint32_t bb[2] = {ld32(kr), ld32(kr + 8)};
        mma_16816(s[j], qa[kk], bb);
      }

    // mask, scale, online softmax; a row lives in the 4 lanes of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kp = kp_s[j * 8 + 2 * t + (e & 1)];
        float val;
        if (kp == kPastEnd) {
          val = -INFINITY;
        } else {
          bool ok = kp >= 0;
          if (causal) ok = ok && qp[i] >= kp;
          if (window > 0) ok = ok && (qp[i] - kp) < window;
          val = ok ? s[j][e] * sm_scale : kNegInf;
        }
        s[j][e] = val;
        mx[i] = fmaxf(mx[i], val);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P's C fragments become A fragments, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = &Vt[(n * 8 + g) * VS + kk * 16 + 2 * t];
        const uint32_t bb[2] = {ld32(vr), ld32(vr + 8)};
        mma_16816(o[n], pa, bb);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    const float li = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (qrow[i] - q);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * i] / li, o[n][2 * i + 1] / li);
  }
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
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* qpos,
                       const int* kpos, void* out, int B, int Sq, int Sk, int KVH,
                       int G, int causal, int window, float sm_scale, cudaStream_t stream) {
  const int qt = kRows / G;
  dim3 grid((Sq + qt - 1) / qt, KVH, B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qpos, kpos,
      static_cast<__nv_bfloat16*>(out), Sq, Sk, KVH, G, causal, window, sm_scale);
  return cudaGetLastError();
}

#define FLASH_ARGS q, k, v, qp, kp, out, B, Sq, Sk, KVH, G, causal, window, sm_scale, s

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA body), 1 = bfloat16 (tensor-core body); q, k, v
// and out all of it.  Requires 1 <= G <= 64, D in {16, 32, 64, 128},
// Sq >= 1, Sk >= 1; for bfloat16 also k and v 16-byte aligned and q and
// out 4-byte aligned.  Returns cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kpos, void* out, int B,
                        int Sq, int Sk, int KVH, int G, int D, int causal,
                        int window, float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kRows || Sq < 1 || Sk < 1 || B < 1 || KVH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_fma<16>(FLASH_ARGS);
      case 32: return launch_fma<32>(FLASH_ARGS);
      case 64: return launch_fma<64>(FLASH_ARGS);
      case 128: return launch_fma<128>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_mma<16>(FLASH_ARGS);
      case 32: return launch_mma<32>(FLASH_ARGS);
      case 64: return launch_mma<64>(FLASH_ARGS);
      case 128: return launch_mma<128>(FLASH_ARGS);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
