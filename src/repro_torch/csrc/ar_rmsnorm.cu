// K1: AllReduce + residual-add + RMSNorm in one kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel / ring_fused_ar_rmsnorm
// (src/repro/kernels/ring_ar_rmsnorm.py), the paper's fused
// AllReduce-RMSNorm (Listing 1).  N ranks of a tensor-parallel group each
// hold a partial sum x_r (T, d) of a row-parallel product and their own
// token slice res_r (C, d) of the residual stream, C = T / N.  For every
// token row i, owned by rank r = i / C (the chunk psum_scatter(tiled)
// gives rank r), the kernel
//   1. loads row i of all N partials and sums them in fp32, rank 0 first,
//      then rounds the sum to x's dtype, as psum_scatter's output is;
//   2. adds res_r[i - r*C] in fp32 and writes that new residual;
//   3. reduces sum(t^2) across the CTA;
//   4. writes t * rsqrt(mean(t^2) + eps) * w into row i of all N outputs,
//      the all-gather.
// Semantics: kernels/ref.ring_ar_rmsnorm_ref, not the Pallas kernel, which
// accumulates hop by hop in x's dtype.
//
// Pointers come as tables of N <= 8 entries passed by value in the kernel's
// arguments, so a launch needs no host-to-device copy.  On one card the
// tables point into (N, T, d) and (N, C, d) tensors; the same body takes
// peer-mapped pointers when the ranks are separate cards.
//
// What bounds it: bytes.  It reads N partials and the residual and writes
// N outputs and the residual: (N + 1) * T * d elements each way, a few
// operations per element.  The grid is the comm budget's CTA count, 1 to 8
// (the paper's 2-8 SM grant), so the kernel leaves the other SMs to the
// compute of the other split; 8 SMs cannot pull the card's full memory
// rate, so the kernel is slower alone than its byte bound by design.  To
// keep as many bytes in flight as a few SMs can, each thread issues its
// N 16-byte loads of a row segment back to back before it adds them, and
// the row's t stays in shared memory between the reduction and the
// scaling (one read and one write of device memory per element).  Each
// row is done by one CTA with a fixed thread mapping, so the budget
// changes which CTA does a row but not one bit of the result.  d need not
// be a multiple of 8: the scalar body takes what 16-byte vectors cannot.
//
// Built with nvcc into a shared library with a C interface and called
// through ctypes (src/repro_torch/kernels/ar_rmsnorm.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxRanks = 8;

// Outside the anonymous namespace: the C entry point takes it, and a
// parameter type with internal linkage would hide that entry point.
struct PtrTable {
  void* p[kMaxRanks];
};

namespace {

constexpr int kMaxCtas = 8;
constexpr int kThreads = 1024;

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

// Sum of v over the CTA, returned to every thread.  Two barriers per call
// make back-to-back calls safe: red is rewritten only after every warp has
// passed the second barrier, total only after all have read it.
__device__ __forceinline__ float block_sum(float v, float* red, float* total) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kThreads / 32 ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) *total = s;
  }
  __syncthreads();
  return *total;
}

// N, the number of ranks, is a template parameter so the loops over ranks
// unroll without predicates and a thread's N loads issue back to back.
template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kThreads)
ar_rmsnorm_kernel(PtrTable x, PtrTable res, const T* __restrict__ w,
                  PtrTable out, PtrTable res_out, int rows, int chunk, int d,
                  float eps) {
  extern __shared__ float t_s[];  // the row's t, d floats
  __shared__ float red[kThreads / 32];
  __shared__ float total;
  constexpr int V = 16 / sizeof(T);

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int owner = row / chunk;
    const int64_t xoff = static_cast<int64_t>(row) * d;
    const int64_t roff = static_cast<int64_t>(row - owner * chunk) * d;
    // select the owner's slabs without indexing the parameter tables at
    // run time, which would copy them to local memory
    const T* rr = static_cast<const T*>(res.p[0]);
    T* ro = static_cast<T*>(res_out.p[0]);
#pragma unroll
    for (int k = 1; k < N; ++k)
      if (owner == k) {
        rr = static_cast<const T*>(res.p[k]);
        ro = static_cast<T*>(res_out.p[k]);
      }
    rr += roff;
    ro += roff;
    float ss = 0.f;

    if constexpr (kVec) {
      const int nv = d / V;
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        uint4 xv[N];
#pragma unroll
        for (int k = 0; k < N; ++k)
          xv[k] = reinterpret_cast<const uint4*>(
              static_cast<const T*>(x.p[k]) + xoff)[i];
        const uint4 rv = reinterpret_cast<const uint4*>(rr)[i];
        float s[V];
        {
          const T* e = reinterpret_cast<const T*>(&xv[0]);
#pragma unroll
          for (int j = 0; j < V; ++j) s[j] = to_f(e[j]);
        }
#pragma unroll
        for (int k = 1; k < N; ++k) {
          const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
          for (int j = 0; j < V; ++j) s[j] += to_f(e[j]);
        }
        const T* re = reinterpret_cast<const T*>(&rv);
        uint4 nres;
        T* ne = reinterpret_cast<T*>(&nres);
        float4 tv[V / 4];
        float* te = reinterpret_cast<float*>(tv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = to_f(from_f<T>(s[j])) + to_f(re[j]);
          te[j] = t;
          ss += t * t;
          ne[j] = from_f<T>(t);
        }
        reinterpret_cast<uint4*>(ro)[i] = nres;
        // 16-byte shared stores: a thread's V floats are contiguous, so
        // scalar stores would conflict V ways across a warp's banks
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          reinterpret_cast<float4*>(t_s)[i * (V / 4) + q] = tv[q];
      }
    } else {
      for (int i = threadIdx.x; i < d; i += kThreads) {
        T xs[N];
#pragma unroll
        for (int k = 0; k < N; ++k) xs[k] = static_cast<const T*>(x.p[k])[xoff + i];
        float s = to_f(xs[0]);
#pragma unroll
        for (int k = 1; k < N; ++k) s += to_f(xs[k]);
        const float t = to_f(from_f<T>(s)) + to_f(rr[i]);
        t_s[i] = t;
        ss += t * t;
        ro[i] = from_f<T>(t);
      }
    }

    const float inv = rsqrtf(block_sum(ss, red, &total) / static_cast<float>(d) + eps);

    // each thread reads back only the t values it wrote itself
    if constexpr (kVec) {
      const int nv = d / V;
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        const uint4 wv = reinterpret_cast<const uint4*>(w)[i];
        const T* we = reinterpret_cast<const T*>(&wv);
        float4 tv[V / 4];
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          tv[q] = reinterpret_cast<const float4*>(t_s)[i * (V / 4) + q];
        const float* te = reinterpret_cast<const float*>(tv);
        uint4 ov;
        T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
        for (int j = 0; j < V; ++j) oe[j] = from_f<T>(te[j] * inv * to_f(we[j]));
#pragma unroll
        for (int k = 0; k < N; ++k)
          reinterpret_cast<uint4*>(static_cast<T*>(out.p[k]) + xoff)[i] = ov;
      }
    } else {
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const T o = from_f<T>(t_s[i] * inv * to_f(w[i]));
#pragma unroll
        for (int k = 0; k < N; ++k) static_cast<T*>(out.p[k])[xoff + i] = o;
      }
    }
  }
}

template <typename T, int N, bool kVec>
cudaError_t launch(const PtrTable& x, const PtrTable& res, const void* w,
                   const PtrTable& out, const PtrTable& res_out, int rows,
                   int d, float eps, int ctas, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = ar_rmsnorm_kernel<T, N, kVec>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = ctas < rows ? ctas : rows;
  kernel<<<grid, kThreads, smem, stream>>>(x, res, static_cast<const T*>(w), out,
                                           res_out, rows, rows / N, d, eps);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_n(const PtrTable& x, const PtrTable& res, const void* w,
                     const PtrTable& out, const PtrTable& res_out, int rows, int d,
                     float eps, int vec, int ctas, cudaStream_t s) {
  return vec ? launch<T, N, true>(x, res, w, out, res_out, rows, d, eps, ctas, s)
             : launch<T, N, false>(x, res, w, out, res_out, rows, d, eps, ctas, s);
}

template <typename T>
cudaError_t launch_t(const PtrTable& x, const PtrTable& res, const void* w,
                     const PtrTable& out, const PtrTable& res_out, int n, int rows,
                     int d, float eps, int vec, int ctas, cudaStream_t s) {
  switch (n) {
    case 1: return launch_n<T, 1>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    case 2: return launch_n<T, 2>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    case 3: return launch_n<T, 3>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    case 4: return launch_n<T, 4>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    case 5: return launch_n<T, 5>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    case 6: return launch_n<T, 6>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    case 7: return launch_n<T, 7>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    case 8: return launch_n<T, 8>(x, res, w, out, res_out, rows, d, eps, vec, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of one pointer table, for the caller to check its own layout.
int ar_rmsnorm_table_bytes() { return static_cast<int>(sizeof(PtrTable)); }

// x, res, out, res_out: host pointers to tables of n device pointers (the
// tables are copied into the kernel's arguments).  rows = T, a multiple of
// n; res and res_out rows are (T / n, d).  dtype: 0 = float32,
// 1 = bfloat16.  vec: 1 when d * sizeof(dtype) is a multiple of 16 and
// every pointer is 16-byte aligned.  ctas: the grid, 1 to 8.  Returns
// cudaGetLastError() after the launch.
int ar_rmsnorm(const PtrTable* x, const PtrTable* res, const void* w,
               const PtrTable* out, const PtrTable* res_out, int n, int rows,
               int d, float eps, int dtype, int vec, int ctas, void* stream) {
  if (n < 1 || n > kMaxRanks || rows % n != 0 || d < 1 || ctas < 1 || ctas > kMaxCtas)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(*x, *res, w, *out, *res_out, n, rows, d, eps, vec, ctas, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(*x, *res, w, *out, *res_out, n, rows, d, eps, vec, ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
