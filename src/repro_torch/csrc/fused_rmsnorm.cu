// K2: fused residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fused_rmsnorm_kernel /
// fused_residual_rmsnorm_pallas (src/repro/kernels/fused_rmsnorm.py).
// Per token row:  t = x + res (fp32);  out = t * rsqrt(mean(t^2) + eps) * w
// cast to x's dtype;  new_res = t cast to res's dtype.
//
// What bounds it: bytes.  It reads x and res and writes out and new_res
// once each (4 * T * d * sizeof(T)), plus w; its arithmetic is a few
// operations per element, far below the card's 295 operations per byte.
// Design: one CTA of 256 threads per token row, 16-byte vector loads and
// stores where d and the pointers allow it (scalar otherwise, so d need
// not be a power of two or a multiple of 8), t kept in shared memory
// between the two passes (no second read of device memory), one block
// reduction of sum(t^2).  Rows are independent, so no padding of T is
// needed: the grid has exactly T blocks.
//
// Built with nvcc into a shared library with a C interface and called
// through ctypes (src/repro_torch/kernels/fused_rmsnorm.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const T* __restrict__ w, T* __restrict__ out,
                     T* __restrict__ res_out, int d, float eps) {
  extern __shared__ float t_s[];  // the row's t = x + res, d floats
  __shared__ float red[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const T* xr = x + base;
  const T* rr = res + base;
  T* orow = out + base;
  T* rorow = res_out + base;
  float ss = 0.f;

  constexpr int V = 16 / sizeof(T);
  if constexpr (kVec) {
    const int nv = d / V;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 xv = reinterpret_cast<const uint4*>(xr)[i];
      uint4 rv = reinterpret_cast<const uint4*>(rr)[i];
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* re = reinterpret_cast<const T*>(&rv);
      uint4 nv_out;
      T* ne = reinterpret_cast<T*>(&nv_out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = to_f(xe[j]) + to_f(re[j]);
        t_s[i * V + j] = t;
        ss += t * t;
        ne[j] = from_f<T>(t);
      }
      reinterpret_cast<uint4*>(rorow)[i] = nv_out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float t = to_f(xr[i]) + to_f(rr[i]);
      t_s[i] = t;
      ss += t * t;
      rorow[i] = from_f<T>(t);
    }
  }

  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / static_cast<float>(d) + eps);

  // each thread reads back only the t values it wrote itself
  if constexpr (kVec) {
    const int nv = d / V;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 wv = reinterpret_cast<const uint4*>(w)[i];
      const T* we = reinterpret_cast<const T*>(&wv);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = from_f<T>(t_s[i * V + j] * inv * to_f(we[j]));
      reinterpret_cast<uint4*>(orow)[i] = ov;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f<T>(t_s[i] * inv * to_f(w[i]));
  }
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const void* res, const void* w, void* out,
                   void* res_out, int rows, int d, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = fused_rmsnorm_kernel<T, kVec>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<T*>(res_out), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, res, w, out and res_out all of it).
// vec: 1 when d * sizeof(dtype) is a multiple of 16 and every pointer is
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
int fused_residual_rmsnorm(const void* x, const void* res, const void* w,
                           void* out, void* res_out, int rows, int d, float eps,
                           int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (dtype == 0)
    return vec ? launch<float, true>(x, res, w, out, res_out, rows, d, eps, s)
               : launch<float, false>(x, res, w, out, res_out, rows, d, eps, s);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, true>(x, res, w, out, res_out, rows, d, eps, s)
               : launch<__nv_bfloat16, false>(x, res, w, out, res_out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
