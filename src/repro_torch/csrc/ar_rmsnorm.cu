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
// rate, so the kernel is slower alone than its byte bound by design.  What
// a few SMs can move is set by the bytes each keeps in flight, and a CTA
// that does one row at a time leaves its loads idle through each row's two
// barriers and N + 1 stores: per-row latency then bounds it (~62 GB/s per
// SM on an H100, 1.218 ms for the shape below).  The pipelined body keeps
// the next row's loads in flight through the current row's reduction and
// stores (the next row's N + 1 vectors per thread in registers, t in
// registers too): on an NVIDIA H100 80GB HBM3 at 700 W, 0.88-0.90 ms for
// N = 8, T = 2048, d = 8192 bf16 on 8 CTAs, against 0.78 ms for a plain
// copy of the same bytes on the same 8 CTAs and 0.180 ms for the whole
// card (chip_smoke.py).  Rows it cannot hold (d * sizeof(T) not a multiple of
// 16, or more than 2 vectors per thread) take the scalar body.  Each row
// is done by one CTA with a fixed thread mapping, so the budget changes
// which CTA does a row but not one bit of the result.
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
// the pipelined body: 512 threads (128 registers each, for the next row's
// N + 1 vectors, t and w), each owning up to kMaxVec 16-byte vectors of a
// row: d <= 8192 bf16, 4096 fp32
constexpr int kPipeThreads = 512;
constexpr int kMaxVec = 2;
// the scalar body's row of t in shared memory
constexpr size_t kMaxSmemBytes = 227 * 1024;

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

// The residual slab (in and out) of the rank that owns a row, selected
// without indexing the parameter tables at run time (which would copy them
// to local memory).
template <typename T, int N>
__device__ __forceinline__ void owner_slab(const PtrTable& res, const PtrTable& res_out,
                                           int row, int chunk, int d, const T*& rr,
                                           T*& ro) {
  const int owner = row / chunk;
  rr = static_cast<const T*>(res.p[0]);
  ro = static_cast<T*>(res_out.p[0]);
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (owner == k) {
      rr = static_cast<const T*>(res.p[k]);
      ro = static_cast<T*>(res_out.p[k]);
    }
  const int64_t roff = static_cast<int64_t>(row - owner * chunk) * d;
  rr += roff;
  ro += roff;
}

// The scalar body, for rows the pipelined body cannot take (d * sizeof(T)
// not a multiple of 16, a pointer not 16-byte aligned, or more than
// kMaxVec vectors per thread): one row at a time, t kept in shared memory
// between the reduction and the scaling.  N, the number of ranks, is a
// template parameter (in both bodies) so the loops over ranks unroll
// without predicates.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ar_rmsnorm_scalar_kernel(PtrTable x, PtrTable res, const T* __restrict__ w,
                         PtrTable out, PtrTable res_out, int rows, int chunk, int d,
                         float eps) {
  extern __shared__ float t_s[];  // the row's t, d floats
  __shared__ float red[kThreads / 32];
  __shared__ float total;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t xoff = static_cast<int64_t>(row) * d;
    const T* rr;
    T* ro;
    owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
    float ss = 0.f;
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
    const float inv = rsqrtf(block_sum(ss, red, &total) / static_cast<float>(d) + eps);
    // each thread reads back only the t values it wrote itself
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const T o = from_f<T>(t_s[i] * inv * to_f(w[i]));
#pragma unroll
      for (int k = 0; k < N; ++k) static_cast<T*>(out.p[k])[xoff + i] = o;
    }
  }
}

// ---- the pipelined body -------------------------------------------------
//
// Each CTA walks its rows (row = blockIdx.x + k * gridDim.x) with 512
// threads, each owning up to kMaxVec 16-byte vectors of a row.  A thread
// holds the next row's N partial vectors and residual vector in registers:
// as soon as it has summed the current row into t (also in registers), it
// issues the next row's loads, which then fly while the current row's
// residual is stored, its sum of squares reduced across the CTA (two
// barriers) and its N outputs written.  Each row is done by one CTA with a
// fixed thread mapping, so every grid gives the same bits.
template <typename T, int N>
__global__ void __launch_bounds__(kPipeThreads)
ar_rmsnorm_kernel(PtrTable x, PtrTable res, const T* __restrict__ w, PtrTable out,
                  PtrTable res_out, int rows, int chunk, int d, float eps) {
  __shared__ float red[kPipeThreads / 32];
  __shared__ float total;
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint4 xv[kMaxVec][N], rv[kMaxVec];   // the next row's segments, in flight
  auto load = [&](int row) {
    const T* rr;
    T* ro;
    owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int i = tid + j * kPipeThreads;
      if (i >= nv) break;
#pragma unroll
      for (int k = 0; k < N; ++k)
        xv[j][k] = reinterpret_cast<const uint4*>(static_cast<const T*>(x.p[k]) +
                                                  static_cast<int64_t>(row) * d)[i];
      rv[j] = reinterpret_cast<const uint4*>(rr)[i];
    }
  };
  uint4 wv[kMaxVec];
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = tid + j * kPipeThreads;
    if (i < nv) wv[j] = reinterpret_cast<const uint4*>(w)[i];
  }
  if (blockIdx.x < rows) load(blockIdx.x);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    float tv[kMaxVec][V];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int i = tid + j * kPipeThreads;
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
    // the next row's loads fly while this one is reduced and stored
    if (row + gridDim.x < rows) load(row + gridDim.x);
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    const T* rr;
    T* ro;
    owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
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
    __syncthreads();
    if (warp == 0) {
      float v = lane < kPipeThreads / 32 ? red[lane] : 0.f;
      v = warp_sum(v);
      if (lane == 0) total = v;
    }
    __syncthreads();
    const float inv = rsqrtf(total / static_cast<float>(d) + eps);
    const int64_t xoff = static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int i = tid + j * kPipeThreads;
      if (i >= nv) break;
      const T* we = reinterpret_cast<const T*>(&wv[j]);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int q = 0; q < V; ++q) oe[q] = from_f<T>(tv[j][q] * inv * to_f(we[q]));
#pragma unroll
      for (int k = 0; k < N; ++k)
        reinterpret_cast<uint4*>(static_cast<T*>(out.p[k]) + xoff)[i] = ov;
    }
  }
}

template <typename T, int N, bool kVec>
cudaError_t launch(const PtrTable& x, const PtrTable& res, const void* w,
                   const PtrTable& out, const PtrTable& res_out, int rows,
                   int d, float eps, int ctas, cudaStream_t stream) {
  // the scalar body keeps t in shared memory: d floats
  const size_t smem = kVec ? 0 : static_cast<size_t>(d) * sizeof(float);
  if (smem > kMaxSmemBytes || (kVec && d / (16 / sizeof(T)) > kMaxVec * kPipeThreads))
    return cudaErrorInvalidValue;
  auto kernel = kVec ? ar_rmsnorm_kernel<T, N> : ar_rmsnorm_scalar_kernel<T, N>;
  // above 48 KB in all, static arrays included, only after opting in
  if (smem > 40 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = ctas < rows ? ctas : rows;
  kernel<<<grid, kVec ? kPipeThreads : kThreads, smem, stream>>>(
      x, res, static_cast<const T*>(w), out, res_out, rows, rows / N, d, eps);
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
// 1 = bfloat16.  vec: 1 runs the pipelined body, which wants d * sizeof(dtype)
// a multiple of 16, at most 1024 16-byte vectors in a row and every pointer
// 16-byte aligned; 0 runs the scalar body (d <= 58112).  ctas: the grid, 1
// to 8.  Returns cudaGetLastError() after the launch.
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
