// K1's row arithmetic, one copy for both of its forms: the one-card form
// (ar_rmsnorm.cu) and the cross-rank form (ar_rmsnorm_peer.cu).  The two
// give the same bits on the same inputs because they run this code: the N
// partials summed in fp32, rank 0 first, rounded to x's dtype, plus the
// residual; sum(t^2) over the same thread mapping and the same two-barrier
// reduction tree; the same rsqrt and scaling.  Each form only says where a
// row's inputs come from and where its outputs go.
//
// Two bodies, picked by the caller as K1 picks them: the vector body (512
// threads, each owning up to kMaxVec 16-byte vectors of a row, t kept in
// registers) and the scalar body (1024 threads, one element at a time, t in
// shared memory), for rows the vector body cannot take.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace k1row {

constexpr int kThreads = 1024;      // the scalar body
constexpr int kPipeThreads = 512;   // the vector body
constexpr int kMaxVec = 2;          // 16-byte vectors per thread and row

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as the reference's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over a CTA of kN threads, in two steps so that a caller can
// issue stores between them: begin leaves each warp's sum in red, end
// returns the total to every thread.  Two barriers in end make back-to-back
// rows safe: red is rewritten only after every warp has passed the second
// barrier, total only after all have read it.
__device__ __forceinline__ void block_sum_begin(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
}

template <int kN>
__device__ __forceinline__ float block_sum_end(const float* red, float* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kN / 32 ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) *total = s;
  }
  __syncthreads();
  return *total;
}

__device__ __forceinline__ float inv_rms(float sum_sq, int d, float eps) {
  return rsqrtf(sum_sq / static_cast<float>(d) + eps);
}

// ---- the vector body ----------------------------------------------------

// A row's t: xv[j][k] is rank k's partial, rv[j] the residual, in the
// thread's j-th vector (column tid + j * kPipeThreads of nv); t goes to tv
// (registers) and the sum of this thread's squares is returned.  A caller
// then issues the next row's loads into xv and rv, which fly while
// vec_finish reduces and stores this one.
template <typename T, int N>
__device__ __forceinline__ float vec_sum(const uint4 (&xv)[kMaxVec][N],
                                         const uint4 (&rv)[kMaxVec], int nv,
                                         float (&tv)[kMaxVec][16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = threadIdx.x + j * kPipeThreads;
    if (i >= nv) break;
    float sum[V];
    {
      const T* e = reinterpret_cast<const T*>(&xv[j][0]);
#pragma unroll
      for (int q = 0; q < V; ++q) sum[q] = to_f(e[q]);
    }
#pragma unroll
    for (int k = 1; k < N; ++k) {
      const T* e = reinterpret_cast<const T*>(&xv[j][k]);
#pragma unroll
      for (int q = 0; q < V; ++q) sum[q] += to_f(e[q]);
    }
    const T* re = reinterpret_cast<const T*>(&rv[j]);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float t = to_f(from_f<T>(sum[q])) + to_f(re[q]);
      tv[j][q] = t;
      ss += t * t;
    }
  }
  return ss;
}

// The rest of the row: the new residual into res_row()'s row, the sum of
// squares over the CTA, and the normed vectors (weight wv[j]) through
// store(i, v).
template <typename T, typename ResRow, typename Store>
__device__ __forceinline__ void vec_finish(const float (&tv)[kMaxVec][16 / sizeof(T)],
                                           float ss, const uint4 (&wv)[kMaxVec], int nv,
                                           int d, float eps, float* red, float* total,
                                           ResRow res_row, Store store) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  block_sum_begin(ss, red);
  T* ro = res_row();
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = tid + j * kPipeThreads;
    if (i >= nv) break;
    uint4 nres;
    T* ne = reinterpret_cast<T*>(&nres);
#pragma unroll
    for (int q = 0; q < V; ++q) ne[q] = from_f<T>(tv[j][q]);
    reinterpret_cast<uint4*>(ro)[i] = nres;
  }
  const float inv = inv_rms(block_sum_end<kPipeThreads>(red, total), d, eps);
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = tid + j * kPipeThreads;
    if (i >= nv) break;
    const T* we = reinterpret_cast<const T*>(&wv[j]);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int q = 0; q < V; ++q) oe[q] = from_f<T>(tv[j][q] * inv * to_f(we[q]));
    store(i, ov);
  }
}

// ---- the scalar body ----------------------------------------------------

// One row: load(k, i) is rank k's partial at column i, rr and ro the
// residual's row in and out, t_s d floats of shared memory; store(i, o)
// writes the normed element i.  Each thread reads back only the t values it
// wrote itself.
template <typename T, int N, typename Load, typename Store>
__device__ __forceinline__ void scalar_row(Load load, const T* rr, T* ro, const T* w,
                                           int d, float eps, float* t_s, float* red,
                                           float* total, Store store) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    T xs[N];
#pragma unroll
    for (int k = 0; k < N; ++k) xs[k] = load(k, i);
    float s = to_f(xs[0]);
#pragma unroll
    for (int k = 1; k < N; ++k) s += to_f(xs[k]);
    const float t = to_f(from_f<T>(s)) + to_f(rr[i]);
    t_s[i] = t;
    ss += t * t;
    ro[i] = from_f<T>(t);
  }
  block_sum_begin(ss, red);
  const float inv = inv_rms(block_sum_end<kThreads>(red, total), d, eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    store(i, from_f<T>(t_s[i] * inv * to_f(w[i])));
}

}  // namespace k1row
