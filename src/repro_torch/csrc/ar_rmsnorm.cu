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
//   3. reduces sum(t^2) over the row's thread group;
//   4. writes t * rsqrt(mean(t^2) + eps) * w into row i of all N outputs,
//      the all-gather.
// Semantics: kernels/ref.ring_ar_rmsnorm_ref, not the Pallas kernel, which
// accumulates hop by hop in x's dtype.
//
// Pointers come as tables of N <= 8 entries passed by value in the kernel's
// arguments, so a launch needs no host-to-device copy.  On one card the
// tables point into (N, T, d) and (N, C, d) tensors.
//
// What bounds it: bytes, (N + 1) T d elements read and as many written, a
// few operations each, on the comm budget's 1 to 8 CTAs (the paper's 2-8
// SM grant), which leave the other SMs to the compute of the other split.
// 8 SMs cannot pull the card's 3.35 TB/s, so what sets the time is the
// bytes each SM keeps in flight.  Until this design a row took the whole
// CTA and two CTA-wide barriers, and a CTA kept at most two rows in
// flight: at d 512 (1 KB rows) per-row latency set the time, 1.451 ms for
// (8, 12000, 512) against 0.066 ms of bytes; at (8, 2048, 8192) 0.881 ms
// against 0.780 ms for a plain copy of the same bytes on the same 8 CTAs.
//
// The design (the row engine, ar_rmsnorm_row.cuh): a row goes to a group of
// threads sized to the row, and a CTA works on 512 / g rows at once, each
// group reducing on its own (warp shuffles, named barriers).  Two routes
// feed the groups; both run the same per-vector arithmetic in the same
// order, so the route changes no bit:
//   * register: each thread holds the next row's N + 1 vectors in
//     registers, loaded while the current row is reduced and stored with
//     ordinary st.global;
//   * bulk, for rows of a whole CTA (513 to 1024 vectors): a producer
//     thread issues cp.async.bulk loads of the row's two column slices of
//     the N partials and the residual into a ring of >= 2 shared-memory
//     stages, completing on mbarriers; the CTA sums from shared memory (t
//     stays in registers: 2 vectors a thread), stages the normed row and
//     the new residual once in shared memory, and one thread writes them
//     to the N outputs and the residual with bulk stores
//     (cp.async.bulk.global.shared::cta).
// kernels/ar_rmsnorm.py route picks the bulk route at rows of a whole CTA,
// 8 ranks and at least 16 rows a CTA, where it was the faster.  Rows the
// vector body cannot hold (d * sizeof(T) not a multiple of 16, or more
// than 1024 vectors) take the scalar body, one row at a time.  Each row is
// done by one group with a mapping fixed by (d, dtype), so the budget, the
// grid and the route change which group does a row but not one bit of the
// result.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, PERF.md §6): up to d
// 4096 the groups keep enough rows in flight to run at the copy probe's
// rate or near it (0.29 ms at (8, 12000, 512), the probe 0.29).  From d
// 6144 a row takes the whole CTA, and one row of loads is in flight.  On
// the register route it drains while the row is reduced and stored, and
// at N 8 the next row's vectors fill half the registers (0.89 against the
// probe's 0.78 ms at (8, 2048, 8192)).  The bulk route keeps its ring
// refilling while the CTA reduces and its stores drain on their own
// (0.81 there); its ring holds no more than a row at N 8 (two stages of
// N + 1 half-row slices fill shared memory), so it needs rows to come:
// at decode sizes (a row or a few a CTA) the ring's set-up costs more
// than it hides.
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

using k1row::kCtaThreads;
using k1row::kMaxVec;
using k1row::kThreads;

constexpr int kMaxCtas = 8;
constexpr size_t kMaxSmemBytes = 227 * 1024;
// the bulk route's dynamic shared memory: what a block may use, less its
// static arrays and a margin
constexpr size_t kBulkSmemBytes = 224 * 1024;
constexpr int kMaxStages = 8;
enum Route { kScalar = 0, kRegister = 1, kBulk = 2 };

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

// The scalar body, for rows the vector body cannot take (d * sizeof(T)
// not a multiple of 16, a pointer not 16-byte aligned, or more than
// kMaxRowVectors vectors): one row at a time, t kept in shared memory
// between the reduction and the scaling (k1row::scalar_row).  N, the
// number of ranks, is a template parameter (in every body) so the loops
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

// ---- the register route -------------------------------------------------
//
// Group q of CTA b walks rows b * R + q + k * gridDim.x * R (R groups of g
// threads, k1row::group_rows).  A thread holds the next row's N partial
// vectors and residual vector in registers: as soon as it has summed the
// current row into t (also in registers, k1row::vec_sum), it issues the
// next row's loads, which then fly while the current row's residual is
// stored, its sum of squares reduced over the group and its N outputs
// written (k1row::vec_finish).  The stores' addresses are formed where
// they are used: at N 8 the next row's vectors take 64 of a thread's 128
// registers.
template <typename T, int N, int G>
__global__ void __launch_bounds__(kCtaThreads)
ar_rmsnorm_kernel(PtrTable x, PtrTable res, const T* __restrict__ w, PtrTable out,
                  PtrTable res_out, int rows, int chunk, int d, float eps) {
  __shared__ float red[k1row::kRedFloats];
  constexpr int V = 16 / sizeof(T), g = G, R = kCtaThreads / G;
  const int nv = d / V;
  int q, lane;
  k1row::group_of<G>(g, q, lane);
  const int stride = gridDim.x * R;
  uint4 xv[kMaxVec][N], rv[kMaxVec];   // the next row's vectors, in flight
  auto load = [&](int row) {
    const T* rr;
    T* ro;
    owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int i = lane + j * g;
      if (i >= nv) break;
#pragma unroll
      for (int k = 0; k < N; ++k)
        xv[j][k] = reinterpret_cast<const uint4*>(static_cast<const T*>(x.p[k]) +
                                                  static_cast<int64_t>(row) * d)[i];
      rv[j] = reinterpret_cast<const uint4*>(rr)[i];
    }
  };
  uint4 wv[kMaxVec];
  k1row::load_weight(wv, w, lane, g, nv);
  int row = blockIdx.x * R + q;
  if (row < rows) load(row);
  for (int k = 0; row < rows; row += stride, ++k) {
    float tv[kMaxVec][V];
    const float ss = k1row::vec_sum<T, N>(xv, rv, lane, g, nv, tv);
    // the next row's loads fly while this one is reduced and stored
    if (row + stride < rows) load(row + stride);
    k1row::vec_finish<T, true>(
        tv, ss, wv, lane, q, g, nv, d, eps, red, k & 1,
        [&](int i, const uint4& v) {
          const T* rr;
          T* ro;
          owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
          reinterpret_cast<uint4*>(ro)[i] = v;
        },
        [&](int i, const uint4& v) {
          const int64_t xoff = static_cast<int64_t>(row) * d;
#pragma unroll
          for (int r = 0; r < N; ++r)
            reinterpret_cast<uint4*>(static_cast<T*>(out.p[r]) + xoff)[i] = v;
        });
  }
}

// ---- the bulk route -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of the given parity has completed.  On a fresh
// barrier, parity 1 counts as completed (the phase before the first).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// global -> shared, completing `bytes` on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// shared -> global, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// every bulk store this thread committed but the last `keep` groups has
// read its shared memory
__device__ __forceinline__ void bulk_wait_read(int keep) {
  if (keep == 0) {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
  }
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// this thread's shared-memory writes, before the async proxy reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The bulk route's shared memory: a ring of `stages` stages of N + 1
// column slices (kCtaThreads vectors each: rank k's partial in slot k, the
// residual in slot N), then `staging` buffers (used by turns) of the new
// residual and the normed row (nv vectors each), then the full and empty
// mbarriers.
struct BulkLayout {
  int stages, staging, nv;
  __host__ __device__ size_t stage_vecs(int n) const {
    return static_cast<size_t>(n + 1) * kCtaThreads;
  }
  __host__ __device__ size_t ring_bytes(int n) const {
    return static_cast<size_t>(stages) * stage_vecs(n) * 16;
  }
  __host__ __device__ size_t staged_bytes() const {
    return static_cast<size_t>(staging) * nv * 16 * 2;
  }
  __host__ __device__ size_t bytes(int n) const {
    return ring_bytes(n) + staged_bytes() + static_cast<size_t>(stages) * 16;
  }
};

// Two staging buffers below 8 ranks, so that a row's stores drain while the
// next row is staged, one from 8 (with two, 2 rows of 8 outputs in flight
// ran slower than one), and the most stages (<= kMaxStages) that fit
// beside them; one buffer where two leave fewer than 2 stages; stages < 2:
// nothing fits.
template <int N>
__host__ __device__ BulkLayout bulk_layout(int nv) {
  BulkLayout l{kMaxStages, N < 8 ? 2 : 1, nv};
  while (l.stages >= 2 && l.bytes(N) > kBulkSmemBytes) --l.stages;
  if (l.stages < 2) {
    l.stages = kMaxStages;
    l.staging = 1;
    while (l.stages >= 2 && l.bytes(N) > kBulkSmemBytes) --l.stages;
  }
  return l;
}

// Rows of a whole CTA only (one row group of kCtaThreads threads, 513 to
// 1024 vectors: two column slices a row).  One producer thread (the warp
// after the group) keeps the ring full: it refills a stage as soon as the
// group's warps have released it (empty mbarrier), announcing the bytes on
// the stage's full mbarrier.  Slice j of a row holds vectors [j 512,
// (j+1) 512), exactly its threads' j-th vectors (the register route's
// mapping).  The consumers read a slice, release it, and once the row's
// slices are summed reduce over the CTA; the normed row and the new
// residual are staged in shared memory and thread 0 writes them with N + 1
// bulk stores.  Before a staging buffer is rewritten thread 0 waits for
// the stores that last read it (bulk_wait_read: with two buffers, those of
// the row before last), ahead of the row's reduction barriers.
template <typename T, int N>
__global__ void __launch_bounds__(kCtaThreads + 32)
ar_rmsnorm_bulk_kernel(PtrTable x, PtrTable res, const T* __restrict__ w, PtrTable out,
                       PtrTable res_out, int rows, int chunk, int d, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[k1row::kRedFloats];
  constexpr int V = 16 / sizeof(T), g = kCtaThreads;
  const int nv = d / V, ns = (nv + g - 1) / g;
  const BulkLayout L = bulk_layout<N>(nv);
  const int S = L.stages;
  uint4* ring = reinterpret_cast<uint4*>(smem);
  uint4* staged = reinterpret_cast<uint4*>(smem + L.ring_bytes(N));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.ring_bytes(N) + L.staged_bytes());
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, g / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= g) {   // the producer warp: one thread issues
    if (tid != g) return;
    int it = 0;
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const T* rr;
      T* ro;
      owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
      for (int j = 0; j < ns; ++j, ++it) {
        const int s = it % S, v0 = j * g;
        mbar_wait(empty + s, ((it / S) & 1) ^ 1);   // released
        const uint32_t bytes = static_cast<uint32_t>(min(g, nv - v0)) * 16;
        uint4* dst = ring + s * L.stage_vecs(N);
        mbar_expect_tx(full + s, (N + 1) * bytes);
#pragma unroll
        for (int k = 0; k < N; ++k)
          bulk_load(dst + k * g,
                    static_cast<const uint4*>(x.p[k]) + static_cast<int64_t>(row) * nv + v0,
                    bytes, full + s);
        bulk_load(dst + N * g, reinterpret_cast<const uint4*>(rr) + v0, bytes, full + s);
      }
    }
    return;
  }

  uint4 wv[kMaxVec];
  k1row::load_weight(wv, w, tid, g, nv);
  int it = 0;   // the slices consumed
  for (int row = blockIdx.x, k = 0; row < rows; row += gridDim.x, ++k) {
    float tv[kMaxVec][V];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      if (j >= ns) break;
      const int s = it % S;
      mbar_wait(full + s, (it / S) & 1);
      if (tid + j * g < nv) {
        const uint4* st = ring + s * L.stage_vecs(N);
        uint4 xv[N];
#pragma unroll
        for (int r = 0; r < N; ++r) xv[r] = st[r * g + tid];
        const uint4 rv = st[N * g + tid];
        k1row::vec_t<T, N>(xv, rv, tv[j], ss);
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty + s);
      ++it;
    }
    uint4* out_row = staged + static_cast<size_t>(k % L.staging) * nv * 2;
    uint4* res_row = out_row + nv;
    // the stores that last used this staging buffer have read it
    if (tid == 0) bulk_wait_read(L.staging - 1);
    const float inv = k1row::inv_rms(k1row::group_sum<true>(ss, 0, g, red, k & 1), d, eps);
    k1row::vec_residual<T>(tv, tid, g, nv, [&](int i, const uint4& v) { res_row[i] = v; });
    k1row::vec_normed<T>(tv, inv, wv, tid, g, nv,
                         [&](int i, const uint4& v) { out_row[i] = v; });
    fence_proxy_async();
    k1row::group_sync(0, g);
    if (tid == 0) {
      const T* rr;
      T* ro;
      owner_slab<T, N>(res, res_out, row, chunk, d, rr, ro);
      const int64_t xoff = static_cast<int64_t>(row) * d;
      const uint32_t bytes = static_cast<uint32_t>(nv) * 16;
#pragma unroll
      for (int r = 0; r < N; ++r) bulk_store(static_cast<T*>(out.p[r]) + xoff, out_row, bytes);
      bulk_store(ro, res_row, bytes);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <typename T, int N, int kRoute>
cudaError_t launch(const PtrTable& x, const PtrTable& res, const void* w,
                   const PtrTable& out, const PtrTable& res_out, int rows,
                   int d, float eps, int ctas, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V;
  if (kRoute != kScalar && nv > k1row::kMaxRowVectors) return cudaErrorInvalidValue;
  const int g = k1row::group_threads(nv);
  size_t smem = 0;
  int threads = kThreads, per_cta = 1;
  if (kRoute == kScalar) {
    smem = static_cast<size_t>(d) * sizeof(float);   // the row's t
  } else {
    per_cta = k1row::group_rows(nv);
    threads = per_cta * g;
  }
  if (kRoute == kBulk) {
    // rows of a whole CTA only
    if (g != k1row::kCtaThreads) return cudaErrorInvalidValue;
    const BulkLayout l = bulk_layout<N>(nv);
    if (l.stages < 2) return cudaErrorInvalidValue;
    smem = l.bytes(N);
    threads += 32;   // the producer warp
  }
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = kRoute == kScalar     ? ar_rmsnorm_scalar_kernel<T, N>
                : kRoute == kRegister ? K1_BY_GROUP(g, ar_rmsnorm_kernel, T, N)
                                      : ar_rmsnorm_bulk_kernel<T, N>;
  // above 48 KB in all, static arrays included, only after opting in
  if (smem > 40 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (rows + per_cta - 1) / per_cta;
  const int grid = ctas < blocks ? ctas : blocks;
  kernel<<<grid, threads, smem, stream>>>(x, res, static_cast<const T*>(w), out, res_out,
                                          rows, rows / N, d, eps);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_n(const PtrTable& x, const PtrTable& res, const void* w,
                     const PtrTable& out, const PtrTable& res_out, int rows, int d,
                     float eps, int route, int ctas, cudaStream_t s) {
  switch (route) {
    case kScalar: return launch<T, N, kScalar>(x, res, w, out, res_out, rows, d, eps, ctas, s);
    case kRegister:
      return launch<T, N, kRegister>(x, res, w, out, res_out, rows, d, eps, ctas, s);
    case kBulk: return launch<T, N, kBulk>(x, res, w, out, res_out, rows, d, eps, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const PtrTable& x, const PtrTable& res, const void* w,
                     const PtrTable& out, const PtrTable& res_out, int n, int rows,
                     int d, float eps, int route, int ctas, cudaStream_t s) {
  switch (n) {
    case 1: return launch_n<T, 1>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    case 2: return launch_n<T, 2>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    case 3: return launch_n<T, 3>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    case 4: return launch_n<T, 4>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    case 5: return launch_n<T, 5>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    case 6: return launch_n<T, 6>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    case 7: return launch_n<T, 7>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    case 8: return launch_n<T, 8>(x, res, w, out, res_out, rows, d, eps, route, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of one pointer table, for the caller to check its own layout.
int ar_rmsnorm_table_bytes() { return static_cast<int>(sizeof(PtrTable)); }

// The row-group rule's constants, for the caller to check its mirror.
int ar_rmsnorm_group_threads(int nv) { return k1row::group_threads(nv); }
int ar_rmsnorm_group_rows(int nv) { return k1row::group_rows(nv); }

// x, res, out, res_out: host pointers to tables of n device pointers (the
// tables are copied into the kernel's arguments).  rows = T, a multiple of
// n; res and res_out rows are (T / n, d).  dtype: 0 = float32,
// 1 = bfloat16.  route: 1 (register) and 2 (bulk) run the vector body,
// which wants d * sizeof(dtype) a multiple of 16, at most 1024 16-byte
// vectors in a row and every pointer 16-byte aligned (the bulk route:
// rows of a whole CTA only, 513 to 1024 vectors); 0 runs the scalar body
// (d <= 58112).  ctas: the grid, 1 to 8.  Returns cudaGetLastError()
// after the launch.
int ar_rmsnorm(const PtrTable* x, const PtrTable* res, const void* w,
               const PtrTable* out, const PtrTable* res_out, int n, int rows,
               int d, float eps, int dtype, int route, int ctas, void* stream) {
  if (n < 1 || n > kMaxRanks || rows % n != 0 || d < 1 || ctas < 1 || ctas > kMaxCtas)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(*x, *res, w, *out, *res_out, n, rows, d, eps, route, ctas, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(*x, *res, w, *out, *res_out, n, rows, d, eps, route,
                                   ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
