// K1, cross-rank form: AllReduce + residual-add + RMSNorm, one launch per
// rank, the ranks reaching each other only through peer-mapped buffers and
// flags, for Hopper (sm_90a).
//
// Replaces the remote part of the Pallas TPU kernel _kernel /
// ring_fused_ar_rmsnorm (src/repro/kernels/ring_ar_rmsnorm.py): its remote
// DMAs to the right neighbour (pltpu.make_async_remote_copy) and the remote
// semaphore signals that free comm slots, over a comm buffer that
// ring_fused_ar_rmsnorm sizes.  Here each rank's workspace
// (src/repro_torch/distributed/peer.py) is mapped into every peer (CUDA
// IPC across processes, or plain pointers for N ranks in one process), and
// the kernel moves the data with ordinary loads and stores through those
// pointers: the same body runs over NVLink once the pointers come from
// other cards.
//
// Semantics: kernels/ref.ring_ar_rmsnorm_ref (src/repro/kernels/ref.py).
// Rank r of N <= 8 holds x_r (T, d), its partial sum, and res_r (C, d), its
// residual chunk, C = T / N; it owns rows [r*C, (r+1)*C) (_chunk_owner).
// Every rank receives the full normed (T, d) and its own new residual
// chunk.  The per-row arithmetic is the one-card K1's, one copy of it
// included by both (ar_rmsnorm_row.cuh): the N partials summed in fp32,
// rank 0 first, rounded to x's dtype, plus the residual; sum(t^2) over the
// same thread mapping and reduction tree (512 threads and 16-byte vectors,
// or 1024 threads and single elements for rows the vector body cannot take,
// exactly as K1 picks); the same rsqrt and scaling.  So its bits equal the
// one-card K1's on the same inputs.
//
// Design: a push reduce-scatter and a pull all-gather.  Local row j of a
// chunk goes to CTA j % G on every rank (G, the grid, is the comm budget's
// CTA count, 1 to 8, the same on every rank), so a CTA waits only on the
// flags of its own rows.
//   Phase 1: CTA b copies its rows of every chunk c != r of x_r (ordinary
//     local memory) into peer c's receive slot r, then raises
//     arrive[b][r] on peer c.
//   Phase 2: CTA b waits for arrive[b][p] from every peer p, sums its rows
//     of the N partials (its own from x_r, the others from its slots),
//     adds res_r, norms, and writes the new residual, its output rows and
//     its `gathered` chunk (peer-visible); then raises ready[b] in its own
//     workspace.
//   Phase 3: CTA b waits for ready[b] of every peer p and copies p's
//     gathered rows into its output, an ordinary tensor.
// Nothing is staged: x is read where it lies and the output is written
// where the caller keeps it.
//
// Flags carry the call's epoch, a count the host raises by one per call on
// every rank, and are never reset.  Two waits per call suffice:
//  * a receive slot is rewritten by rank p in call e+1 only after p's
//    launch e has ended (stream order), and p's launch e ended only after
//    every CTA of p saw ready[b] = e from every rank, i.e. after every rank
//    had finished reading its slots in phase 2 of call e (ready is raised
//    after phase 2);
//  * a gathered chunk is rewritten by rank c in phase 2 of call e+1 only
//    after arrive[b] = e+1 from every peer, and a peer pushes for e+1 only
//    after its launch e has ended, i.e. after it has pulled every gathered
//    chunk of call e;
//  * so no flag is read while a later call may write it, and a flag >= the
//    epoch is this call's signal.  This holds whatever T and G a call has,
//    since every hazard is closed by a whole launch ending.
// Writes are made visible with __threadfence_system() by every writing
// thread, a CTA barrier, then st.release.sys of the flag; a wait is
// ld.acquire.sys, a fence and a barrier; the receiving CTA reads the data
// with ld.global.cg (L2, not a stale L1 line).  The order is the system
// scope's, so the same code is right across NVLink.  A spin backs off with
// __nanosleep and gives up after kTimeoutNs of %globaltimer with __trap():
// a lost peer becomes a CUDA error in the caller, not a hang.
//
// What bounds it: bytes.  The function moves what the one-card K1 moves,
// 2 (N + 1) T d elements (each partial and residual read once, each output
// written once): 604 MB at N 8, T 2048, d 8192 bf16, 0.180 ms at 3.35 TB/s.
// This design moves more, because a partial is written into a peer's slot
// and read back, and a normed chunk is written once more to `gathered`:
// per rank it reads (3 (N-1) + 2) T d / N and writes (2 (N-1) + 3) T d / N
// elements, 168 MB at that shape, 1.34 GB over the 8 ranks, 0.40 ms at
// 3.35 TB/s on one card, where every "remote" access is HBM.  Across
// cards each rank sends 2 (N-1) T d / N elements over NVLink and receives
// as many, 58.7 MB each way at that shape, 0.13 ms at 450 GB/s.  On one
// card N ranks of G CTAs run on N*G SMs at once (64 at N 8), so unlike the
// one-card K1 on G SMs this form is not held back by its grid at N 8.  Phase
// 2's vector body is the one-card K1's pipelined one (the next row's loads
// in flight while a row is reduced and stored: every row has arrived once
// the phase starts); the scalar body does one row at a time.
//
// Built with nvcc into a shared library with a C interface and called
// through ctypes (src/repro_torch/kernels/ar_rmsnorm_peer.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <type_traits>

#include "ar_rmsnorm_row.cuh"

constexpr int kMaxRanks = 8;

// Outside the anonymous namespace: the C entry point takes it.  Built on
// the host (kernels/ar_rmsnorm_peer.py `tables`); entries of this rank in
// push, recv and arrive_out are null (never read).
struct PeerTables {
  void* push[kMaxRanks];        // [c]: peer c's receive slot of this rank
  void* recv[kMaxRanks];        // [p]: this rank's receive slot of peer p
  void* gathered[kMaxRanks];    // [p]: rank p's gathered chunk
  unsigned long long* arrive_out[kMaxRanks];  // [c]: peer c's arrive[0][rank]
  unsigned long long* ready[kMaxRanks];       // [p]: rank p's ready[0]
  unsigned long long* arrive_in;              // this rank's arrive[0][0]
  void* gathered_own;                         // gathered[rank]
  unsigned long long* ready_own;              // ready[rank]
};

namespace {

using k1row::kMaxVec;
using k1row::kPipeThreads;
using k1row::kThreads;

constexpr int kMaxCtas = 8;
constexpr size_t kMaxSmemBytes = 227 * 1024;
constexpr unsigned long long kTimeoutNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Spin until *flag >= epoch; trap after kTimeoutNs.
__device__ void wait_flag(const unsigned long long* flag, unsigned long long epoch,
                          int phase, int rank, int peer) {
  if (ld_acquire(flag) >= epoch) return;
  const unsigned long long t0 = globaltimer();
  unsigned ns = 32;
  while (ld_acquire(flag) < epoch) {
    __nanosleep(ns);
    if (ns < 256) ns <<= 1;
    if (globaltimer() - t0 > kTimeoutNs) {
      printf("ar_rmsnorm_peer: rank %d CTA %d gave up on peer %d in phase %d "
             "(epoch %llu, flag %llu)\n",
             rank, static_cast<int>(blockIdx.x), peer, phase, epoch, ld_acquire(flag));
      __trap();
    }
  }
}

// The element a thread moves at a time: a 16-byte vector, or one T.
template <typename T, bool kVec>
using Unit = typename std::conditional<kVec, uint4, T>::type;

template <typename U> __device__ __forceinline__ U load_cg(const U* p) { return __ldcg(p); }

// Row j's partials (own from xo, the others from the receive slots) and
// residual into the vector body's registers.
template <int N>
__device__ __forceinline__ void load_row(uint4 (&xv)[kMaxVec][N], uint4 (&rv)[kMaxVec],
                                         const PeerTables& tab, const uint4* xo,
                                         const uint4* res, int j, int nv, int rank) {
  const int64_t off = static_cast<int64_t>(j) * nv;
#pragma unroll
  for (int jj = 0; jj < kMaxVec; ++jj) {
    const int i = threadIdx.x + jj * kPipeThreads;
    if (i >= nv) break;
    // one unconditional load per rank (a pointer select, no branch), as the
    // one-card K1 loads: so xv and rv stay in registers
#pragma unroll
    for (int p = 0; p < N; ++p) {
      const uint4* src = p == rank ? xo : static_cast<const uint4*>(tab.recv[p]);
      xv[jj][p] = load_cg(src + off + i);
    }
    rv[jj] = res[off + i];
  }
}

// Row j through the scalar body (k1row::scalar_row): 1024 threads, t in
// shared memory.
template <typename T, int N>
__device__ __forceinline__ void norm_row_scalar(const PeerTables& tab, const T* xo,
                                                const T* rr, T* ro, T* out, T* gath,
                                                const T* w, int j, int d, float eps,
                                                int rank, float* t_s, float* red,
                                                float* total) {
  const int64_t off = static_cast<int64_t>(j) * d;
  k1row::scalar_row<T, N>(
      [&](int p, int i) -> T {
        if (p == rank) return xo[off + i];
        return load_cg(static_cast<const T*>(tab.recv[p]) + off + i);
      },
      rr + off, ro + off, w, d, eps, t_s, red, total, [&](int i, T o) {
        out[off + i] = o;
        gath[off + i] = o;
      });
}

template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kVec ? kPipeThreads : kThreads)
ar_rmsnorm_peer_kernel(PeerTables tab, const T* __restrict__ x,
                       const T* __restrict__ res, const T* __restrict__ w,
                       T* __restrict__ out, T* __restrict__ res_out, int rank,
                       int chunk, int d, float eps, unsigned long long epoch) {
  extern __shared__ float t_s[];     // the scalar body's row of t
  __shared__ float red[kThreads / 32];
  __shared__ float total;
  using U = Unit<T, kVec>;
  constexpr int kPer = sizeof(U) / sizeof(T);
  const int nu = d / kPer;           // units in a row
  const int tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;

  // Phase 1: this CTA's rows of every other rank's chunk into that rank's
  // receive slot for this rank
  for (int j = b; j < chunk; j += G) {
    for (int i = tid; i < nu; i += blockDim.x) {
      U v[N];
#pragma unroll
      for (int c = 0; c < N; ++c)
        if (c != rank)
          v[c] = reinterpret_cast<const U*>(x)[static_cast<int64_t>(c * chunk + j) * nu + i];
#pragma unroll
      for (int c = 0; c < N; ++c)
        if (c != rank)
          static_cast<U*>(tab.push[c])[static_cast<int64_t>(j) * nu + i] = v[c];
    }
  }
  __threadfence_system();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c != rank) st_release(tab.arrive_out[c] + b * kMaxRanks, epoch);
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p != rank) wait_flag(tab.arrive_in + b * kMaxRanks + p, epoch, 2, rank, p);
    __threadfence_system();
  }
  __syncthreads();

  // Phase 2: the owned chunk's rows
  const T* xo = x + static_cast<int64_t>(rank) * chunk * d;
  T* out_own = out + static_cast<int64_t>(rank) * chunk * d;
  T* gath = static_cast<T*>(tab.gathered_own);
  if constexpr (kVec) {
    // the one-card K1's pipelined body: row j's N partials (own from xo,
    // the others from the receive slots, all arrived) and residual in
    // registers, the next row's loaded while this one is reduced and stored
    uint4 xv[kMaxVec][N], rv[kMaxVec], wv[kMaxVec];
    const uint4* xo_v = reinterpret_cast<const uint4*>(xo);
    const uint4* res_v = reinterpret_cast<const uint4*>(res);
#pragma unroll
    for (int jj = 0; jj < kMaxVec; ++jj) {
      const int i = tid + jj * kPipeThreads;
      if (i < nu) wv[jj] = reinterpret_cast<const uint4*>(w)[i];
    }
    if (b < chunk) load_row<N>(xv, rv, tab, xo_v, res_v, b, nu, rank);
    for (int j = b; j < chunk; j += G) {
      float tv[kMaxVec][kPer];
      const float ss = k1row::vec_sum<T, N>(xv, rv, nu, tv);
      if (j + G < chunk) load_row<N>(xv, rv, tab, xo_v, res_v, j + G, nu, rank);
      k1row::vec_finish<T>(
          tv, ss, wv, nu, d, eps, red, &total,
          [&] { return res_out + static_cast<int64_t>(j) * d; },
          [&](int i, const uint4& ov) {
            const int64_t off = static_cast<int64_t>(j) * nu;
            reinterpret_cast<uint4*>(out_own)[off + i] = ov;
            reinterpret_cast<uint4*>(gath)[off + i] = ov;
          });
    }
  } else {
    for (int j = b; j < chunk; j += G)
      norm_row_scalar<T, N>(tab, xo, res, res_out, out_own, gath, w, j, d, eps, rank,
                            t_s, red, &total);
  }
  __threadfence_system();
  __syncthreads();
  if (tid == 0) {
    st_release(tab.ready_own + b, epoch);
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p != rank) wait_flag(tab.ready[p] + b, epoch, 3, rank, p);
    __threadfence_system();
  }
  __syncthreads();

  // Phase 3: every other rank's gathered rows into the output
  for (int j = b; j < chunk; j += G) {
    for (int i = tid; i < nu; i += blockDim.x) {
      U v[N];
#pragma unroll
      for (int p = 0; p < N; ++p)
        if (p != rank)
          v[p] = load_cg(static_cast<const U*>(tab.gathered[p]) +
                         static_cast<int64_t>(j) * nu + i);
#pragma unroll
      for (int p = 0; p < N; ++p)
        if (p != rank)
          reinterpret_cast<U*>(out)[static_cast<int64_t>(p * chunk + j) * nu + i] = v[p];
    }
  }
}

template <typename T, int N, bool kVec>
cudaError_t launch(const PeerTables& tab, const void* x, const void* res, const void* w,
                   void* out, void* res_out, int rank, int rows, int d, float eps,
                   unsigned long long epoch, int ctas, cudaStream_t stream) {
  const size_t smem = kVec ? 0 : static_cast<size_t>(d) * sizeof(float);
  if (smem > kMaxSmemBytes || (kVec && d / (16 / sizeof(T)) > kMaxVec * kPipeThreads))
    return cudaErrorInvalidValue;
  auto kernel = ar_rmsnorm_peer_kernel<T, N, kVec>;
  if (smem > 40 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // every CTA takes part in the flags, rows or none: the grid is the same
  // on every rank
  kernel<<<ctas, kVec ? kPipeThreads : kThreads, smem, stream>>>(
      tab, static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<T*>(out), static_cast<T*>(res_out), rank,
      rows / N, d, eps, epoch);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_n(const PeerTables& tab, const void* x, const void* res, const void* w,
                     void* out, void* res_out, int rank, int rows, int d, float eps,
                     unsigned long long epoch, int vec, int ctas, cudaStream_t s) {
  return vec ? launch<T, N, true>(tab, x, res, w, out, res_out, rank, rows, d, eps, epoch,
                                  ctas, s)
             : launch<T, N, false>(tab, x, res, w, out, res_out, rank, rows, d, eps,
                                   epoch, ctas, s);
}

template <typename T>
cudaError_t launch_t(const PeerTables& tab, const void* x, const void* res, const void* w,
                     void* out, void* res_out, int n, int rank, int rows, int d, float eps,
                     unsigned long long epoch, int vec, int ctas, cudaStream_t s) {
#define AR_PEER_CASE(K)                                                              \
  case K:                                                                            \
    return launch_n<T, K>(tab, x, res, w, out, res_out, rank, rows, d, eps, epoch, vec, \
                          ctas, s);
  switch (n) {
    AR_PEER_CASE(1)
    AR_PEER_CASE(2)
    AR_PEER_CASE(3)
    AR_PEER_CASE(4)
    AR_PEER_CASE(5)
    AR_PEER_CASE(6)
    AR_PEER_CASE(7)
    AR_PEER_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef AR_PEER_CASE
}

}  // namespace

extern "C" {

// Bytes of the pointer tables and of an IPC handle, for the caller to
// check its own layout.
int ar_rmsnorm_peer_table_bytes() { return static_cast<int>(sizeof(PeerTables)); }
int peer_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// A zeroed device buffer of `bytes` on `device` for a rank's workspace.
int peer_alloc(int device, unsigned long long bytes, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

int peer_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFree(ptr);
  return static_cast<int>(e);
}

// The IPC handle of a buffer from peer_alloc, into `handle`
// (peer_handle_bytes() bytes).
int peer_get_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(e);
}

// Map another process's buffer into this one.  CUDA refuses a process's
// own handle: a rank uses its local pointer for its own buffer.
int peer_open_handle(int device, const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(e);
}

int peer_close_handle(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(e);
}

// One rank's launch.  tab: host pointer to this rank's tables (copied into
// the kernel's arguments).  x (rows, d), res and res_out (rows / n, d), out
// (rows, d), w (d,): this rank's local tensors.  rows a multiple of n.
// epoch: this call's, > every earlier call's of the workspace.  dtype: 0 =
// float32, 1 = bfloat16.  vec: 1 runs the vector body (d * sizeof(dtype) a
// multiple of 16, at most 1024 16-byte vectors a row, every pointer 16-byte
// aligned), 0 the scalar body.  ctas: the grid, 1 to 8, the same on every
// rank.  Returns cudaGetLastError() after the launch.
int ar_rmsnorm_peer(const PeerTables* tab, const void* x, const void* res, const void* w,
                    void* out, void* res_out, int n, int rank, int rows, int d, float eps,
                    unsigned long long epoch, int dtype, int vec, int ctas, void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || rows % n != 0 || d < 1 ||
      ctas < 1 || ctas > kMaxCtas || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(*tab, x, res, w, out, res_out, n, rank, rows, d, eps, epoch, vec,
                           ctas, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(*tab, x, res, w, out, res_out, n, rank, rows, d, eps,
                                   epoch, vec, ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
