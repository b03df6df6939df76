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
// chunk.  The per-row arithmetic is the one-card K1's row engine, one copy
// of it included by both (ar_rmsnorm_row.cuh): rows go to thread groups
// sized to the row, by the rule both forms share, with the same sums in
// the same order.  So its bits equal the one-card K1's on the same inputs,
// on any grid and through either path below.
//
// Two paths, picked by the wrapper (kernels/ar_rmsnorm_peer.py small_t):
//
// The three-phase path, a push reduce-scatter and a pull all-gather.  A
// CTA's rows come in blocks of R (the row engine's groups of a CTA): local
// rows [k R, (k+1) R) of a chunk go to CTA k % G on every rank (G, the
// grid, is the comm budget's CTA count, 1 to 8, the same on every rank),
// so a CTA waits only on the flags of its own rows.
//   Phase 1: CTA b copies its rows of every chunk c != r of x_r (ordinary
//     local memory) into peer c's receive slot r, then raises
//     arrive[b][r] on peer c.
//   Phase 2: CTA b waits for arrive[b][p] from every peer p; its groups
//     sum their rows of the N partials (its own from x_r, the others from
//     its slots), add res_r, norm, and write the new residual, the output
//     rows and its `gathered` chunk (peer-visible); then it raises ready[b]
//     in its own workspace.
//   Phase 3: CTA b waits for ready[b] of every peer p and copies p's
//     gathered rows into its output, an ordinary tensor.
//
// The one-wait path, for small T (T / N below the CTA count: decode and
// verify), where three phases and two flag waits cost more than the rows.
// CTA b of every rank takes the same rows of the whole T (blocks of R,
// CTAs that would have none are not launched).  It publishes its rows of
// x_r, and of those its rows of res_r, into its workspace's publish block
// of the call's parity, and raises pub[b].  After one wait, on pub[b] of
// every peer, it computes its rows from the peers' published partials and
// the owner's published residual, writes them into its output and keeps
// the new residual of the rows it owns.
//
// Epochs.  Every flag carries the call's epoch and is never reset.  The
// epoch lives in device memory, in the workspace (epoch[kMaxCtas]): CTA b
// reads epoch[b] + 1 at its start and, at its end, writes that value to
// every slot k = b (mod G), so all kMaxCtas slots hold it after the launch
// whatever the grid was, and no slot is written in a launch while another
// CTA of it may read that slot.  Every rank makes the same calls in the
// same order, so the ranks' epochs agree; a captured call replayed from a
// CUDA graph reads a fresh epoch.
//
// Why these waits suffice, for any sequence of calls of either path with
// any T and G (each hazard is closed by a whole launch ending):
//  (P1) every launch e of rank p waits on a flag that every peer r raises
//       in its own launch e, and r's launch e starts after its launch e-1
//       ended (stream order).  So when p's launch e has ended, every peer's
//       launch e-1 has ended, reads included.
//  * a receive slot of rank r is written by peer p in phase 1 of a call e'
//    and read by r in phase 2 of an earlier call e.  If e' = e + 1, p's
//    launch e ended after every CTA of p saw ready[b] = e from r, which r
//    raised after its phase 2; if e' >= e + 2, P1.  The same for
//    `gathered` of p, read by r in phase 3 of call e and rewritten in
//    phase 2 of e' only after p saw arrive[b] = e' from r, which r raised
//    after its launch e'-1 ended.
//  * a publish block of parity e & 1 is written in calls e, e + 2, ...: a
//    peer's read in call e is over before the rank's launch e + 1 has
//    ended (P1), which precedes its write in call e + 2.  The next call,
//    e + 1, writes the other parity while a peer may still read this one.
//    A one-wait call thus needs no second flag: the double buffer takes
//    the place of phase 3's wait.
//  * a flag >= the epoch is this call's signal: flags only grow, a peer is
//    at most one call ahead (P1), and a call's signal is raised only after
//    its data is written.
// Writes are made visible by a CTA barrier, then one thread's
// __threadfence_system() (cumulative: it orders the writes the barrier
// ordered before it) and st.release.sys of the flag; a wait is
// ld.acquire.sys, a fence and a barrier; the receiving CTA reads peer data
// with ld.global.cg (L2, not a stale L1 line).  The order is the system
// scope's, so the same code is right across NVLink.  A spin backs off with
// __nanosleep and gives up after kTimeoutNs of %globaltimer with __trap():
// a lost peer becomes a CUDA error in the caller, not a hang.
//
// What bounds it: bytes, and at small T latency.  The function moves what
// the one-card K1 moves, 2 (N + 1) T d elements (each partial and residual
// read once, each output written once): 604 MB at N 8, T 2048, d 8192 bf16,
// 0.180 ms at 3.35 TB/s.  The three-phase path moves more, because a
// partial is written into a peer's slot and read back, and a normed chunk
// is written once more to `gathered`: per rank it reads (3 (N-1) + 2) T d /
// N and writes (2 (N-1) + 3) T d / N elements, 1.34 GB over the 8 ranks at
// that shape, 0.40 ms at 3.35 TB/s on one card.  Across cards each rank
// sends 2 (N-1) T d / N elements over NVLink and receives as many.  The
// one-wait path reads N T d elements per rank (every rank computes every
// row), N / 3 times the three-phase path's reads, which only a small T
// can afford; in return it has one flag wait instead of two and no phase 3.
// There a call's fixed cost (its launch, the flag round trip) bounds it,
// and with N ranks on one card that cost grows with N (PERF.md §6).  On
// one card N ranks of G CTAs run on N*G SMs at once.
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
  void* pub[kMaxRanks];                       // [p]: rank p's publish block, parity 0
  unsigned long long* pub_flag[kMaxRanks];    // [p]: rank p's pub[0]
  unsigned long long* arrive_in;              // this rank's arrive[0][0]
  void* gathered_own;                         // gathered[rank]
  unsigned long long* ready_own;              // ready[rank]
  unsigned long long* epoch;                  // this rank's epoch[0]
  unsigned long long pub_stride;              // bytes from parity 0's block to 1's
  unsigned long long pub_res;                 // the residual's offset in a block
};

namespace {

using k1row::kCtaThreads;
using k1row::kMaxVec;
using k1row::kRedFloats;
using k1row::kThreads;
// red holds the scalar body's warp sums too
static_assert(kRedFloats >= kThreads / 32, "red");

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

// This call's epoch, one more than the last (CTA b's slot), to every
// thread of the CTA.
__device__ __forceinline__ unsigned long long read_epoch(const PeerTables& tab,
                                                         unsigned long long* shared) {
  if (threadIdx.x == 0) *shared = *const_cast<volatile unsigned long long*>(
                                      tab.epoch + blockIdx.x) + 1;
  __syncthreads();
  return *shared;
}

// The epoch into every slot k = blockIdx.x (mod gridDim.x), by one thread
// at the CTA's end: the next launch reads it, on any grid.
__device__ __forceinline__ void advance_epoch(const PeerTables& tab,
                                              unsigned long long epoch) {
  if (threadIdx.x == 0)
    for (int k = blockIdx.x; k < kMaxCtas; k += gridDim.x) tab.epoch[k] = epoch;
}

// The element a thread moves at a time: a 16-byte vector, or one T.
template <typename T, bool kVec>
using Unit = typename std::conditional<kVec, uint4, T>::type;

template <typename U> __device__ __forceinline__ U load_cg(const U* p) { return __ldcg(p); }

// The copies walk CTA b's rows (blocks b, b + G, ... of R rows each) unit
// by unit over the CTA's threads; each thread loads kU units before it
// stores any, so about 8 loads a thread are in flight (a load then a store
// at a time left phases 1 and 3 bound by latency at small N).
template <int N>
__host__ __device__ constexpr int copy_unroll() {
  return N <= 2 ? 8 : N <= 4 ? 2 : 1;
}

// Phase 1: CTA b's rows of every chunk c != rank of x into peer c's
// receive slot of this rank.
template <typename U, int N>
__device__ __forceinline__ void push_rows(const PeerTables& tab, const U* __restrict__ x,
                                          int rank, int R, int chunk, int nu) {
  constexpr int kU = copy_unroll<N>();
  for (int blk = blockIdx.x; blk * R < chunk; blk += gridDim.x) {
    const int j0 = blk * R, total = min(R, chunk - j0) * nu;
    for (int u0 = threadIdx.x; u0 < total; u0 += kU * blockDim.x) {
      U v[kU][N];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int u = u0 + k * blockDim.x;
        if (u >= total) break;
        const int j = j0 + u / nu, i = u % nu;
#pragma unroll
        for (int c = 0; c < N; ++c)
          if (c != rank) v[k][c] = x[static_cast<int64_t>(c * chunk + j) * nu + i];
      }
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int u = u0 + k * blockDim.x;
        if (u >= total) break;
        const int64_t off = static_cast<int64_t>(j0 + u / nu) * nu + u % nu;
#pragma unroll
        for (int c = 0; c < N; ++c)
          if (c != rank) static_cast<U*>(tab.push[c])[off] = v[k][c];
      }
    }
  }
}

// Phase 3: CTA b's rows of every other rank's gathered chunk into out.
template <typename U, int N>
__device__ __forceinline__ void pull_rows(const PeerTables& tab, U* __restrict__ out,
                                          int rank, int R, int chunk, int nu) {
  constexpr int kU = copy_unroll<N>();
  for (int blk = blockIdx.x; blk * R < chunk; blk += gridDim.x) {
    const int j0 = blk * R, total = min(R, chunk - j0) * nu;
    for (int u0 = threadIdx.x; u0 < total; u0 += kU * blockDim.x) {
      U v[kU][N];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int u = u0 + k * blockDim.x;
        if (u >= total) break;
        const int64_t off = static_cast<int64_t>(j0 + u / nu) * nu + u % nu;
#pragma unroll
        for (int p = 0; p < N; ++p)
          if (p != rank) v[k][p] = load_cg(static_cast<const U*>(tab.gathered[p]) + off);
      }
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int u = u0 + k * blockDim.x;
        if (u >= total) break;
        const int j = j0 + u / nu, i = u % nu;
#pragma unroll
        for (int p = 0; p < N; ++p)
          if (p != rank) out[static_cast<int64_t>(p * chunk + j) * nu + i] = v[k][p];
      }
    }
  }
}

// The one-wait path's publish: CTA b's rows (of all T) of x into px, and
// those of them this rank owns ([own0, own0 + chunk)) of res into pr.
template <typename U>
__device__ __forceinline__ void publish_rows(const U* __restrict__ x, const U* __restrict__ res,
                                             U* px, U* pr, int R, int rows, int own0,
                                             int chunk, int nu) {
  constexpr int kU = 4;
  for (int blk = blockIdx.x; blk * R < rows; blk += gridDim.x) {
    const int j0 = blk * R, total = min(R, rows - j0) * nu;
    for (int u0 = threadIdx.x; u0 < total; u0 += kU * blockDim.x) {
      U v[kU], r[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int u = u0 + k * blockDim.x;
        if (u >= total) break;
        const int j = j0 + u / nu, i = u % nu;
        v[k] = x[static_cast<int64_t>(j) * nu + i];
        if (j >= own0 && j < own0 + chunk) r[k] = res[static_cast<int64_t>(j - own0) * nu + i];
      }
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int u = u0 + k * blockDim.x;
        if (u >= total) break;
        const int j = j0 + u / nu, i = u % nu;
        px[static_cast<int64_t>(j) * nu + i] = v[k];
        if (j >= own0 && j < own0 + chunk) pr[static_cast<int64_t>(j - own0) * nu + i] = r[k];
      }
    }
  }
}

// The vector body over rows j = blockIdx.x * R + q + k * G * R below
// `rows` (the row engine's groups), with the one-card K1's loads: the next
// row's vectors fly while a row is reduced and stored.  Row j's partial
// of rank p is at src(p, j) (p == rank: this rank's own x, so one
// unconditional ld.global.cg a rank and a pointer select, no branch),
// its residual at res_row(j); put_res(j, i, v) stores its new residual,
// store(j, i, v) its output.  The lambdas return pointers; the loads and
// the registers they fill stay in this function, as in the one-card K1.
// G: the group size as a compile-time constant (the three phases), or 0
// for the rule's at run time (the one-wait path, bound by latency).
template <typename T, int N, int G, typename Src, typename ResRow, typename PutRes,
          typename Store>
__device__ __forceinline__ void vec_rows(int rows, int d, float eps, const T* w, float* red,
                                         Src src, ResRow res_row, PutRes put_res,
                                         Store store) {
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V, g = G ? G : k1row::group_threads(nv), R = kCtaThreads / g;
  int q, lane;
  k1row::group_of<G>(g, q, lane);
  const int stride = gridDim.x * R;
  uint4 xv[kMaxVec][N], rv[kMaxVec], wv[kMaxVec];
  k1row::load_weight(wv, w, lane, g, nv);
  auto load = [&](int j) {
    const uint4* rr = res_row(j);
#pragma unroll
    for (int jj = 0; jj < kMaxVec; ++jj) {
      const int i = lane + jj * g;
      if (i >= nv) break;
#pragma unroll
      for (int p = 0; p < N; ++p) xv[jj][p] = load_cg(src(p, j) + i);
      rv[jj] = load_cg(rr + i);
    }
  };
  int j = blockIdx.x * R + q;
  if (j < rows) load(j);
  for (int k = 0; j < rows; j += stride, ++k) {
    float tv[kMaxVec][V];
    const float ss = k1row::vec_sum<T, N>(xv, rv, lane, g, nv, tv);
    if (j + stride < rows) load(j + stride);
    k1row::vec_finish<T, false>(
        tv, ss, wv, lane, q, g, nv, d, eps, red, k & 1,
        [&](int i, const uint4& v) { put_res(j, i, v); },
        [&](int i, const uint4& v) { store(j, i, v); });
  }
}

// The residual chunk's rows of rank `owner`, from this rank's res where it
// is the owner, else from the owner's publish block: selected without
// indexing the parameter tables at run time.
template <typename T, int N>
__device__ __forceinline__ const T* owner_res(const PeerTables& tab, const T* res,
                                              int owner, int rank, int parity) {
  const T* r = res;
#pragma unroll
  for (int p = 0; p < N; ++p)
    if (owner == p && p != rank)
      r = reinterpret_cast<const T*>(static_cast<const char*>(tab.pub[p]) +
                                     parity * tab.pub_stride + tab.pub_res);
  return r;
}

// a[k] for a run-time k < N, without indexing the parameter tables at run
// time
template <int N, typename P>
__device__ __forceinline__ P pick(const P (&a)[kMaxRanks], int k) {
  P v = a[0];
#pragma unroll
  for (int p = 1; p < N; ++p)
    if (k == p) v = a[p];
  return v;
}

template <typename T>
__device__ __forceinline__ const T* pub_x(const PeerTables& tab, int p, int parity) {
  return reinterpret_cast<const T*>(static_cast<const char*>(tab.pub[p]) +
                                    parity * tab.pub_stride);
}

template <typename T, int N, bool kVec, int G>
__global__ void __launch_bounds__(kVec ? kCtaThreads : kThreads)
ar_rmsnorm_peer_kernel(PeerTables tab, const T* __restrict__ x,
                       const T* __restrict__ res, const T* __restrict__ w,
                       T* __restrict__ out, T* __restrict__ res_out, int rank,
                       int chunk, int d, float eps) {
  extern __shared__ float t_s[];     // the scalar body's row of t
  __shared__ float red[kRedFloats];   // the scalar body's warp sums, or the row groups'
  __shared__ float total;
  __shared__ unsigned long long epoch_s;
  using U = Unit<T, kVec>;
  constexpr int kPer = sizeof(U) / sizeof(T);
  const int nu = d / kPer;           // units in a row
  const int R = kVec ? k1row::group_rows(nu) : 1;
  const int tid = threadIdx.x, b = blockIdx.x;
  const unsigned long long epoch = read_epoch(tab, &epoch_s);

  // Phase 1: this CTA's rows of every other rank's chunk into that rank's
  // receive slot for this rank
  push_rows<U, N>(tab, reinterpret_cast<const U*>(x), rank, R, chunk, nu);
  __syncthreads();
  if (tid == 0) {
    __threadfence_system();   // the CTA's writes, ordered before it by the barrier
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
    const uint4* xo_v = reinterpret_cast<const uint4*>(xo);
    const uint4* res_v = reinterpret_cast<const uint4*>(res);
    vec_rows<T, N, G>(
        chunk, d, eps, w, red,
        [&](int p, int j) {
          return (p == rank ? xo_v : static_cast<const uint4*>(tab.recv[p])) +
                 static_cast<int64_t>(j) * nu;
        },
        [&](int j) { return res_v + static_cast<int64_t>(j) * nu; },
        [&](int j, int i, const uint4& v) {
          reinterpret_cast<uint4*>(res_out)[static_cast<int64_t>(j) * nu + i] = v;
        },
        [&](int j, int i, const uint4& v) {
          const int64_t off = static_cast<int64_t>(j) * nu + i;
          reinterpret_cast<uint4*>(out_own)[off] = v;
          reinterpret_cast<uint4*>(gath)[off] = v;
        });
  } else {
    for (int j = b; j < chunk; j += gridDim.x) {
      const int64_t off = static_cast<int64_t>(j) * d;
      k1row::scalar_row<T, N>(
          [&](int p, int i) -> T {
            if (p == rank) return xo[off + i];
            return load_cg(static_cast<const T*>(tab.recv[p]) + off + i);
          },
          res + off, res_out + off, w, d, eps, t_s, red, &total, [&](int i, T o) {
            out_own[off + i] = o;
            gath[off + i] = o;
          });
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence_system();
    st_release(tab.ready_own + b, epoch);
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p != rank) wait_flag(tab.ready[p] + b, epoch, 3, rank, p);
    __threadfence_system();
  }
  __syncthreads();

  // Phase 3: every other rank's gathered rows into the output
  pull_rows<U, N>(tab, reinterpret_cast<U*>(out), rank, R, chunk, nu);
  advance_epoch(tab, epoch);
}

// The one-wait path (source note): every rank computes every row of a
// small T from the partials and residual rows its peers published.
template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kVec ? kCtaThreads : kThreads)
ar_rmsnorm_peer_small_kernel(PeerTables tab, const T* __restrict__ x,
                             const T* __restrict__ res, const T* __restrict__ w,
                             T* __restrict__ out, T* __restrict__ res_out, int rank,
                             int rows, int d, float eps) {
  extern __shared__ float t_s[];
  __shared__ float red[kRedFloats];   // the scalar body's warp sums, or the row groups'
  __shared__ float total;
  __shared__ unsigned long long epoch_s;
  using U = Unit<T, kVec>;
  constexpr int kPer = sizeof(U) / sizeof(T);
  const int nu = d / kPer, chunk = rows / N;
  const int R = kVec ? k1row::group_rows(nu) : 1;
  const int tid = threadIdx.x, b = blockIdx.x;
  const unsigned long long epoch = read_epoch(tab, &epoch_s);
  const int parity = static_cast<int>(epoch & 1);

  // publish this CTA's rows of x, and those it owns of the residual
  U* px = reinterpret_cast<U*>(static_cast<char*>(pick<N>(tab.pub, rank)) +
                               parity * tab.pub_stride);
  U* pr = reinterpret_cast<U*>(reinterpret_cast<char*>(px) + tab.pub_res);
  const int own0 = rank * chunk;
  publish_rows<U>(reinterpret_cast<const U*>(x), reinterpret_cast<const U*>(res), px, pr, R,
                  rows, own0, chunk, nu);
  __syncthreads();
  if (tid == 0) {
    __threadfence_system();
    st_release(pick<N>(tab.pub_flag, rank) + b, epoch);
  }
  // one wait: thread p on peer p
#pragma unroll
  for (int p = 0; p < N; ++p)
    if (tid == p && p != rank) {
      wait_flag(tab.pub_flag[p] + b, epoch, 1, rank, p);
      __threadfence_system();
    }
  __syncthreads();

  if constexpr (kVec) {
    const uint4* x_v = reinterpret_cast<const uint4*>(x);
    vec_rows<T, N, 0>(
        rows, d, eps, w, red,
        [&](int p, int j) {
          return (p == rank ? x_v : pub_x<uint4>(tab, p, parity)) +
                 static_cast<int64_t>(j) * nu;
        },
        [&](int j) {
          const int owner = j / chunk;
          return reinterpret_cast<const uint4*>(owner_res<T, N>(tab, res, owner, rank, parity)) +
                 static_cast<int64_t>(j - owner * chunk) * nu;
        },
        [&](int j, int i, const uint4& v) {
          if (j >= own0 && j < own0 + chunk)
            reinterpret_cast<uint4*>(res_out)[static_cast<int64_t>(j - own0) * nu + i] = v;
        },
        [&](int j, int i, const uint4& v) {
          reinterpret_cast<uint4*>(out)[static_cast<int64_t>(j) * nu + i] = v;
        });
  } else {
    T* sink = reinterpret_cast<T*>(t_s + d);   // the new residual of rows it does not own
    for (int j = b; j < rows; j += gridDim.x) {
      const int owner = j / chunk;
      const int64_t off = static_cast<int64_t>(j) * d;
      const int64_t roff = static_cast<int64_t>(j - owner * chunk) * d;
      k1row::scalar_row<T, N>(
          [&](int p, int i) -> T {
            if (p == rank) return x[off + i];
            return load_cg(pub_x<T>(tab, p, parity) + off + i);
          },
          owner_res<T, N>(tab, res, owner, rank, parity) + roff,
          owner == rank ? res_out + roff : sink, w, d, eps, t_s, red, &total,
          [&](int i, T o) { out[off + i] = o; });
    }
  }
  advance_epoch(tab, epoch);
}

template <typename T, int N, bool kVec, bool kSmall>
cudaError_t launch(const PeerTables& tab, const void* x, const void* res, const void* w,
                   void* out, void* res_out, int rank, int rows, int d, float eps, int ctas,
                   cudaStream_t stream) {
  constexpr int kPer = kVec ? 16 / sizeof(T) : 1;
  const int nu = d / kPer;
  if (kVec && nu > k1row::kMaxRowVectors) return cudaErrorInvalidValue;
  // the scalar body keeps t in shared memory (d floats), and the one-wait
  // path a row of T behind it for the residual rows it does not own
  const size_t smem =
      kVec ? 0 : static_cast<size_t>(d) * sizeof(float) + (kSmall ? d * sizeof(T) : 0);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  using Kernel = void (*)(PeerTables, const T*, const T*, const T*, T*, T*, int, int, int,
                         float);
  Kernel kernel;
  if constexpr (kSmall) {
    kernel = ar_rmsnorm_peer_small_kernel<T, N, kVec>;
  } else if constexpr (kVec) {
    kernel = K1_BY_GROUP(k1row::group_threads(nu), ar_rmsnorm_peer_kernel, T, N, true);
  } else {
    kernel = ar_rmsnorm_peer_kernel<T, N, false, 0>;
  }
  if (smem > 40 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int R = kVec ? k1row::group_rows(nu) : 1;
  const int threads = kVec ? R * k1row::group_threads(nu) : kThreads;
  // three phases: every CTA takes part in the flags, rows or none (the grid
  // is the same on every rank); one wait: only CTAs with rows
  int grid = ctas;
  if (kSmall) {
    const int blocks = (rows + R - 1) / R;
    grid = blocks < ctas ? blocks : ctas;
  }
  kernel<<<grid, threads, smem, stream>>>(
      tab, static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<T*>(res_out), rank, kSmall ? rows : rows / N, d,
      eps);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_n(const PeerTables& tab, const void* x, const void* res, const void* w,
                     void* out, void* res_out, int rank, int rows, int d, float eps, int vec,
                     int small, int ctas, cudaStream_t s) {
  if (vec)
    return small ? launch<T, N, true, true>(tab, x, res, w, out, res_out, rank, rows, d, eps,
                                           ctas, s)
                 : launch<T, N, true, false>(tab, x, res, w, out, res_out, rank, rows, d,
                                            eps, ctas, s);
  return small ? launch<T, N, false, true>(tab, x, res, w, out, res_out, rank, rows, d, eps,
                                          ctas, s)
               : launch<T, N, false, false>(tab, x, res, w, out, res_out, rank, rows, d, eps,
                                           ctas, s);
}

template <typename T>
cudaError_t launch_t(const PeerTables& tab, const void* x, const void* res, const void* w,
                     void* out, void* res_out, int n, int rank, int rows, int d, float eps,
                     int vec, int small, int ctas, cudaStream_t s) {
#define AR_PEER_CASE(K)                                                                 \
  case K:                                                                               \
    return launch_n<T, K>(tab, x, res, w, out, res_out, rank, rows, d, eps, vec, small, \
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
// the kernel's arguments; the epoch is in the workspace they point to).
// x (rows, d), res and res_out (rows / n, d), out (rows, d), w (d,): this
// rank's local tensors.  rows a multiple of n.  dtype: 0 = float32, 1 =
// bfloat16.  vec: 1 runs the vector body (d * sizeof(dtype) a multiple of
// 16, at most 1024 16-byte vectors a row, every pointer 16-byte aligned), 0
// the scalar body.  small: 1 takes the one-wait path (rows within the
// workspace's publish blocks), 0 the three phases.  ctas: the grid, 1 to
// 8, the same on every rank.  Returns cudaGetLastError() after the launch.
int ar_rmsnorm_peer(const PeerTables* tab, const void* x, const void* res, const void* w,
                    void* out, void* res_out, int n, int rank, int rows, int d, float eps,
                    int dtype, int vec, int small, int ctas, void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || rows % n != 0 || rows < 1 ||
      d < 1 || ctas < 1 || ctas > kMaxCtas)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(*tab, x, res, w, out, res_out, n, rank, rows, d, eps, vec, small,
                           ctas, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(*tab, x, res, w, out, res_out, n, rank, rows, d, eps, vec,
                                   small, ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
