// K1's row engine, one copy for both of its forms: the one-card form
// (ar_rmsnorm.cu) and the cross-rank form (ar_rmsnorm_peer.cu).  The two
// give the same bits on the same inputs because they run this code: the N
// partials summed in fp32, rank 0 first, rounded to x's dtype, plus the
// residual; sum(t^2) over the same thread mapping and the same reduction
// tree; the same rsqrt and scaling.  Each form only says where a row's
// inputs come from and where its outputs go.
//
// What bounds K1 is bytes, on the 1-8 SMs the comm budget grants it, so
// what matters is how many bytes each SM keeps in flight.  A row used to
// take the whole CTA: at d 512 bf16 a row is 64 16-byte vectors, so 448 of
// 512 threads idled, and every row paid two CTA-wide barriers; per-row
// latency, not bytes, set the time (153 GB/s at d 512).  Now a row goes to
// a group of threads sized to the row (the row-group rule below), and a
// CTA works on kCtaThreads / g rows at once: 16 at d 512 bf16, 1 at d
// 6144 and 8192.  A group reduces its sum of squares with warp shuffles
// and, when it spans several warps, a named barrier of its own (bar.sync
// 1 + q, g; two where the group is the whole CTA): no row waits on
// another row.
//
// The rule depends on (d, dtype) only, and so does the order of every sum,
// so K1 gives the same bits on any grid and in both forms.
//
// Two bodies, picked by the caller as K1 picks them: the vector body (rows
// of at most kMaxRowVectors 16-byte vectors, t in registers) and the
// scalar body (1024 threads, one element at a time, t in shared memory)
// for rows that are not whole 16-byte vectors (d 8190) or are wider.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace k1row {

constexpr int kThreads = 1024;      // the scalar body
constexpr int kCtaThreads = 512;    // the vector body: the row groups of a CTA
constexpr int kMaxVec = 2;          // 16-byte vectors per thread and row
constexpr int kMaxRowVectors = kMaxVec * kCtaThreads;   // d <= 8192 bf16
constexpr int kMaxGroups = kCtaThreads / 32;            // rows of a CTA
// the reduction's shared floats: two parity buffers of warp sums, and the
// total of a whole-CTA group
constexpr int kRedFloats = 2 * kMaxGroups + 1;

// The row-group rule.  A row of nv 16-byte vectors goes to g threads, each
// owning vectors lane and lane + g: the smallest power of two from a warp
// to kCtaThreads that holds the row in kMaxVec vectors a thread.  A CTA
// runs group_rows(nv) = kCtaThreads / g such groups, all its threads.  The
// kernels take g as a template parameter (K1_BY_GROUP): with a group size
// known only at run time, rows of a whole CTA ran slower than the earlier
// whole-CTA kernel.  kernels/ar_rmsnorm.py row_group mirrors the rule.
__host__ __device__ constexpr int group_threads(int nv) {
  int g = 32;
  while (g < kCtaThreads && g * kMaxVec < nv) g *= 2;
  return g;
}
__host__ __device__ constexpr int group_rows(int nv) {
  return kCtaThreads / group_threads(nv);
}

// The thread's row group q and its lane in it, for the group size G (0:
// g known only at run time).  For a group of the whole CTA q is the
// constant 0, so a CTA's row index stays warp-uniform and its address
// arithmetic can sit in uniform registers: with q taken from threadIdx.x
// whole-CTA rows ran a few per cent slower (PERF.md §6, PR 27).
template <int G>
__device__ __forceinline__ void group_of(int g, int& q, int& lane) {
  if (G == kCtaThreads) {
    q = 0;
    lane = threadIdx.x;
  } else {
    q = threadIdx.x / g;
    lane = threadIdx.x % g;
  }
}

// KERNEL<args..., G> for the rule's group size g (32, 64, 128, 256 or
// 512), G a compile-time constant: the kernel instance of a row's group.
#define K1_BY_GROUP(g, KERNEL, ...)          \
  ((g) == 32    ? KERNEL<__VA_ARGS__, 32>    \
   : (g) == 64  ? KERNEL<__VA_ARGS__, 64>    \
   : (g) == 128 ? KERNEL<__VA_ARGS__, 128>   \
   : (g) == 256 ? KERNEL<__VA_ARGS__, 256>   \
                : KERNEL<__VA_ARGS__, 512>)

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

__device__ __forceinline__ float inv_rms(float sum_sq, int d, float eps) {
  return rsqrtf(sum_sq / static_cast<float>(d) + eps);
}

// ---- the vector body ----------------------------------------------------

// A barrier over the q-th row group of g threads (a warp, or the named
// barrier 1 + q; 0 is __syncthreads, and g >= 64 leaves at most 8 groups).
// g is a compile-time constant in every caller but the cross-rank one-wait
// path's.
__device__ __forceinline__ void group_sync(int q, int g) {
  if (g == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + q), "r"(g) : "memory");
  }
}

// The sum of v over the q-th group of g threads, in two steps so that a
// caller can issue stores between them: begin returns the warp's sum (warp
// shuffles) and, in a group of several warps, leaves it in red; end
// returns the group's total to every thread.  One tree for every g and
// both schemes below: lane k takes warp k mod nw's sum, and xor shuffles
// at offsets nw/2 .. 1 add them (a butterfly: every lane gets the same
// bits).  Every warp adds them after one named barrier, red alternating
// with the parity of the group's row count, so a row's warp sums are
// rewritten only two rows later, after every thread has passed the next
// row's barrier.  kFirstWarp: in a group of the whole CTA the first warp
// alone adds them between two barriers and hands the total on through red
// (the earlier whole-CTA kernel's scheme).  The schemes differ only in
// speed: the one-card K1 ran faster with kFirstWarp, the cross-rank form
// without (PERF.md §6, PR 27).  red: kRedFloats floats.
template <bool kFirstWarp>
__device__ __forceinline__ float group_sum_begin(float v, int q, int g, float* red,
                                                 int parity) {
  v = warp_sum(v);
  if (g > 32 && (threadIdx.x & 31) == 0) {
    const int nw = g / 32;
    const int at = kFirstWarp && g == kCtaThreads ? 0 : parity * kMaxGroups + q * nw;
    red[at + (threadIdx.x % g) / 32] = v;
  }
  return v;
}

template <bool kFirstWarp>
__device__ __forceinline__ float group_sum_end(float v, int q, int g, float* red,
                                               int parity) {
  if (g == 32) return v;
  const int nw = g / 32, lane = threadIdx.x & 31;
  auto tree = [&](const float* r) {
    float s = r[lane & (nw - 1)];
#pragma unroll
    for (int o = kMaxGroups / 2; o > 0; o >>= 1)
      if (o < nw) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  };
  group_sync(q, g);
  if (kFirstWarp && g == kCtaThreads) {
    float* total = red + 2 * kMaxGroups;
    if (threadIdx.x < 32) {
      const float s = tree(red);
      if (lane == 0) *total = s;
    }
    group_sync(q, g);
    return *total;
  }
  return tree(red + parity * kMaxGroups + q * nw);
}

template <bool kFirstWarp>
__device__ __forceinline__ float group_sum(float v, int q, int g, float* red, int parity) {
  return group_sum_end<kFirstWarp>(group_sum_begin<kFirstWarp>(v, q, g, red, parity), q,
                                   g, red, parity);
}

// One vector of a row: x[k] is rank k's partial, r the residual.  t goes
// to t[], and its squares are added to ss in element order.
template <typename T, int N>
__device__ __forceinline__ void vec_t(const uint4 (&x)[N], const uint4& r,
                                      float (&t)[16 / sizeof(T)], float& ss) {
  constexpr int V = 16 / sizeof(T);
  float sum[V];
  {
    const T* e = reinterpret_cast<const T*>(&x[0]);
#pragma unroll
    for (int q = 0; q < V; ++q) sum[q] = to_f(e[q]);
  }
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const T* e = reinterpret_cast<const T*>(&x[k]);
#pragma unroll
    for (int q = 0; q < V; ++q) sum[q] += to_f(e[q]);
  }
  const T* re = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int q = 0; q < V; ++q) {
    t[q] = to_f(from_f<T>(sum[q])) + to_f(re[q]);
    ss += t[q] * t[q];
  }
}

// A row's t from registers: xv[j][k] is rank k's partial, rv[j] the
// residual, in the thread's j-th vector (vector lane + j * g of nv); t goes
// to tv and the sum of this thread's squares is returned.  A caller then
// issues the next row's loads into xv and rv, which fly while vec_finish
// reduces and stores this one.
template <typename T, int N>
__device__ __forceinline__ float vec_sum(const uint4 (&xv)[kMaxVec][N],
                                         const uint4 (&rv)[kMaxVec], int lane, int g,
                                         int nv, float (&tv)[kMaxVec][16 / sizeof(T)]) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    if (lane + j * g >= nv) break;
    vec_t<T, N>(xv[j], rv[j], tv[j], ss);
  }
  return ss;
}

// The new residual of a row, t rounded to T: put(i, v) for each of the
// thread's vectors i.
template <typename T, typename Put>
__device__ __forceinline__ void vec_residual(const float (&tv)[kMaxVec][16 / sizeof(T)],
                                             int lane, int g, int nv, Put put) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = lane + j * g;
    if (i >= nv) break;
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int q = 0; q < V; ++q) e[q] = from_f<T>(tv[j][q]);
    put(i, v);
  }
}

// The normed row, t * inv * w (weight vectors wv[j]): put(i, v).
template <typename T, typename Put>
__device__ __forceinline__ void vec_normed(const float (&tv)[kMaxVec][16 / sizeof(T)],
                                           float inv, const uint4 (&wv)[kMaxVec], int lane,
                                           int g, int nv, Put put) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = lane + j * g;
    if (i >= nv) break;
    const T* we = reinterpret_cast<const T*>(&wv[j]);
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int q = 0; q < V; ++q) e[q] = from_f<T>(tv[j][q] * inv * to_f(we[q]));
    put(i, v);
  }
}

// The rest of a row in the register route: the warp's sum of squares, the
// new residual through put_res(i, v) (its stores fly while the group
// reduces), the group's sum (group_sum's kFirstWarp), and the normed
// vectors through store(i, v).
template <typename T, bool kFirstWarp, typename PutRes, typename Store>
__device__ __forceinline__ void vec_finish(const float (&tv)[kMaxVec][16 / sizeof(T)],
                                           float ss, const uint4 (&wv)[kMaxVec], int lane,
                                           int q, int g, int nv, int d, float eps,
                                           float* red, int parity, PutRes put_res,
                                           Store store) {
  const float part = group_sum_begin<kFirstWarp>(ss, q, g, red, parity);
  vec_residual<T>(tv, lane, g, nv, put_res);
  const float inv = inv_rms(group_sum_end<kFirstWarp>(part, q, g, red, parity), d, eps);
  vec_normed<T>(tv, inv, wv, lane, g, nv, store);
}

// The weight's vectors of this thread.
__device__ __forceinline__ void load_weight(uint4 (&wv)[kMaxVec], const void* w, int lane,
                                            int g, int nv) {
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = lane + j * g;
    if (i < nv) wv[j] = reinterpret_cast<const uint4*>(w)[i];
  }
}

// ---- the scalar body ----------------------------------------------------

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
