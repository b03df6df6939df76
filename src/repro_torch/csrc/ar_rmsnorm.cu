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

#include "ar_rmsnorm_row.cuh"

constexpr int kMaxRanks = 8;

// Outside the anonymous namespace: the C entry point takes it, and a
// parameter type with internal linkage would hide that entry point.
struct PtrTable {
  void* p[kMaxRanks];
};

namespace {

// the scalar body's 1024 threads; the pipelined body's 512 (128 registers
// each, for the next row's N + 1 vectors, t and w), each owning up to
// kMaxVec 16-byte vectors of a row: d <= 8192 bf16, 4096 fp32
using k1row::kMaxVec;
using k1row::kPipeThreads;
using k1row::kThreads;

constexpr int kMaxCtas = 8;
// the scalar body's row of t in shared memory
constexpr size_t kMaxSmemBytes = 227 * 1024;

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
// between the reduction and the scaling (k1row::scalar_row).  N, the
// number of ranks, is a template parameter (in both bodies) so the loops
// over ranks unroll without predicates.
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
    k1row::scalar_row<T, N>(
        [&](int k, int i) { return static_cast<const T*>(x.p[k])[xoff + i]; }, rr, ro,
        w, d, eps, t_s, red, &total, [&](int i, T o) {
#pragma unroll
          for (int k = 0; k < N; ++k) static_cast<T*>(out.p[k])[xoff + i] = o;
        });
  }
}

// ---- the pipelined body -------------------------------------------------
//
// Each CTA walks its rows (row = blockIdx.x + k * gridDim.x) with 512
// threads, each owning up to kMaxVec 16-byte vectors of a row.  A thread
// holds the next row's N partial vectors and residual vector in registers:
// as soon as it has summed the current row into t (also in registers,
// k1row::vec_sum), it issues the next row's loads, which then fly while
// the current row's residual is stored, its sum of squares reduced across
// the CTA (two barriers) and its N outputs written (k1row::vec_finish).  Each row is done
// by one CTA with a fixed thread mapping, so every grid gives the same bits.
template <typename T, int N>
__global__ void __launch_bounds__(kPipeThreads)
ar_rmsnorm_kernel(PtrTable x, PtrTable res, const T* __restrict__ w, PtrTable out,
                  PtrTable res_out, int rows, int chunk, int d, float eps) {
  __shared__ float red[kPipeThreads / 32];
  __shared__ float total;
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V, tid = threadIdx.x;
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
    const float ss = k1row::vec_sum<T, N>(xv, rv, nv, tv);
    // the next row's loads fly while this one is reduced and stored
    if (row + gridDim.x < rows) load(row + gridDim.x);
    k1row::vec_finish<T>(
        tv, ss, wv, nv, d, eps, red, &total,
        [&] {
          const T* rr;
          T* ro;
          owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
          return ro;
        },
        [&](int i, const uint4& ov) {
          const int64_t xoff = static_cast<int64_t>(row) * d;
#pragma unroll
          for (int k = 0; k < N; ++k)
            reinterpret_cast<uint4*>(static_cast<T*>(out.p[k]) + xoff)[i] = ov;
        });
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
