// Trainable banded ops for sm_90a: the endpoint-row gather of one edge family
// and the per-node sum of its rows at the sorted endpoint, each with its
// backward (kernels 7, 7b, 8, 8b).
//
// Replaces: yolat_tpu/ops/banded_train.py
//   banded_gather       (_gather_kernel :64, pallas_call at :143; its VJP
//                        _gather_bwd :294 = _scatter_call :216 twice, the
//                        _scatter_kernel :157 with pallas_call at :257 and the
//                        spill-tile combination at :264-272)
//   banded_scatter_own  (_scatter_call with target_oth False; its VJP
//                        _scatter_own_bwd :319 = _gather_impl, own_only)
// over the plan of ops/plans.banded_plan(transpose=True): the family's E real
// edges sorted by the endpoint `own`, absolute node rows own/oth [E], the
// per-node offsets nptr [n + 1] of that list, and its transpose by the other
// endpoint, tperm [E] (the rows stably sorted by oth) with offsets tptr [n + 1].
//   7   x_own[r] = x[own r],  x_oth[r] = x[oth r]                  (x's type)
//   7b  dx[v] = sum_{own r = v} g_own[r] + sum_{oth r = v} g_oth[r]
//               (two f32 sums, added, rounded to x's type)
//   8   out[v] = sum_{own r = v} rows[r]                           (f32)
//   8b  d_rows[r] = round(g[own r])                                (rows' type)
// Rounding follows the TPU kernels: a gathered row is a copy, exact in any
// type (they return it in f32 and the caller rounds it back); every sum
// accumulates in f32 over terms of the working type; 7b rounds once at the
// end, after adding its two sums (:298-300); 8b rounds g before it gathers
// (:324).
//
// What bounds them on the H100: bytes. Each moves O(E * C) values once and
// adds at most once per value. The TPU kernels turn each gather and each sum
// into one-hot MXU contractions of 256-row edge blocks against a 512-node
// window with 128-row halos, pad the list to whole blocks with masked rows,
// and collect the other endpoint's sums in spill tiles, because a TPU has no
// fast row gather and no scatter. Hopper reads rows directly, so none of that
// is carried over, and there is no masked row:
//   * the gathers (7, 8b) are one thread per 16 bytes (7) or per element (8b)
//     of the output, consecutive threads on consecutive addresses of one row;
//   * the sums (8, 7b) take one warp per node: the clique family is
//     lower-triangular all-pairs per proposal, so a node's run is anything
//     from 0 to hundreds of rows, and a thread per (node, channel) would make
//     a block wait for its longest node. A lane owns two neighbouring
//     channels (one 4- or 8-byte load per row, a warp reads 128 or 256
//     contiguous bytes), keeps four independent row loads in flight and adds
//     them in list order: own rows are contiguous (nptr), other-endpoint rows
//     come through tperm in ascending row order. A node's sum is formed by
//     one warp in a fixed order, in registers: no float atomics,
//     bit-identical across runs, and every output row is written once.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 132 * 64;
constexpr int UNROLL = 4;  // row loads a lane keeps in flight

int blocks_for(long total, int per_block) {
  long b = (total + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Kernel 7. V is the copy unit: uint4 when a row is a whole number of
// 16-byte units, else the element type; vpr units per row. Rows are clamped
// into range for memory safety only: banded_plan rejects endpoints outside
// [0, n).
template <typename V>
__global__ void __launch_bounds__(THREADS) gather_pair_kernel(
    const V* __restrict__ x, const int* __restrict__ own, const int* __restrict__ oth,
    V* __restrict__ out_own, V* __restrict__ out_oth, int n, int e, int vpr) {
  const long total = (long)e * vpr;
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const int r = (int)(i / vpr), q = (int)(i - (long)r * vpr);
    out_own[i] = x[(size_t)clampi(own[r], n - 1) * vpr + q];
    out_oth[i] = x[(size_t)clampi(oth[r], n - 1) * vpr + q];
  }
}

// The f32 sums of channels k, k + 1 over rows[row(i)] for i in [p0, p1), in
// that order; row(i) = perm[i], or i without a permutation.
template <typename T, bool PERM>
__device__ __forceinline__ float2 sum_rows(const T* __restrict__ rows,
                                           const int* __restrict__ perm, int p0, int p1,
                                           int e, int c, int k) {
  float2 acc = make_float2(0.f, 0.f);
  int i = p0;
  for (; i + UNROLL <= p1; i += UNROLL) {
    float2 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int r = PERM ? clampi(perm[i + j], e - 1) : i + j;
      v[j] = load2<T>(rows + (size_t)r * c + k);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      acc.x += v[j].x;
      acc.y += v[j].y;
    }
  }
  for (; i < p1; ++i) {
    const int r = PERM ? clampi(perm[i], e - 1) : i;
    const float2 v = load2<T>(rows + (size_t)r * c + k);
    acc.x += v.x;
    acc.y += v.y;
  }
  return acc;
}

// Kernel 8: one warp per node, c even.
template <typename T>
__global__ void __launch_bounds__(THREADS) scatter_own_kernel(
    const T* __restrict__ rows, const int* __restrict__ nptr, float* __restrict__ out,
    int n, int e, int c) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * WARPS;
  for (int v = blockIdx.x * WARPS + (threadIdx.x >> 5); v < n; v += warps) {
    const int p0 = clampi(nptr[v], e), p1 = clampi(nptr[v + 1], e);
    for (int k = 2 * lane; k < c; k += 64) {
      const float2 s = sum_rows<T, false>(rows, nullptr, p0, p1, e, c, k);
      store2(out + (size_t)v * c + k, s.x, s.y);
    }
  }
}

// Kernel 7b: one warp per node, c even; the own-endpoint sum over the node's
// run of the sorted list, the other-endpoint sum through the transpose.
template <typename T>
__global__ void __launch_bounds__(THREADS) gather_bwd_kernel(
    const T* __restrict__ g_own, const T* __restrict__ g_oth,
    const int* __restrict__ nptr, const int* __restrict__ tperm,
    const int* __restrict__ tptr, T* __restrict__ dx, int n, int e, int c) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * WARPS;
  for (int v = blockIdx.x * WARPS + (threadIdx.x >> 5); v < n; v += warps) {
    const int p0 = clampi(nptr[v], e), p1 = clampi(nptr[v + 1], e);
    const int t0 = clampi(tptr[v], e), t1 = clampi(tptr[v + 1], e);
    for (int k = 2 * lane; k < c; k += 64) {
      const float2 a = sum_rows<T, false>(g_own, nullptr, p0, p1, e, c, k);
      const float2 b = sum_rows<T, true>(g_oth, tperm, t0, t1, e, c, k);
      store2(dx + (size_t)v * c + k, a.x + b.x, a.y + b.y);
    }
  }
}

// Kernel 8b: one thread per output element.
template <typename T>
__global__ void __launch_bounds__(THREADS) scatter_own_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ own, T* __restrict__ out,
    int n, int e, int c) {
  const long total = (long)e * c;
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const int r = (int)(i / c), k = (int)(i - (long)r * c);
    out[i] = yk::from_f<T>(g[(size_t)clampi(own[r], n - 1) * c + k]);
  }
}

template <typename V>
int launch_gather(const void* x, const void* own, const void* oth, void* out_own,
                  void* out_oth, int n, int e, int vpr, cudaStream_t st) {
  gather_pair_kernel<V><<<blocks_for((long)e * vpr, THREADS), THREADS, 0, st>>>(
      static_cast<const V*>(x), static_cast<const int*>(own),
      static_cast<const int*>(oth), static_cast<V*>(out_own),
      static_cast<V*>(out_oth), n, e, vpr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel 7. x [n, c] (f32, or bf16 when bf16 != 0); own/oth [e] i32;
// out_own/out_oth [e, c] in x's type. Each entry point returns the CUDA
// error code of its launch.
int yk_banded_gather(const void* x, const void* own, const void* oth, void* out_own,
                     void* out_oth, int n, int e, int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_bytes = c * (bf16 ? 2 : 4);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out_own) |
                         reinterpret_cast<uintptr_t>(out_oth);
  if (row_bytes % 16 == 0 && ptrs % 16 == 0)
    return launch_gather<uint4>(x, own, oth, out_own, out_oth, n, e, row_bytes / 16, st);
  if (bf16)
    return launch_gather<__nv_bfloat16>(x, own, oth, out_own, out_oth, n, e, c, st);
  return launch_gather<float>(x, own, oth, out_own, out_oth, n, e, c, st);
}

// Kernel 7b. g_own/g_oth [e, c] (f32 or bf16); nptr/tptr [n + 1] i32; tperm
// [e] i32; dx [n, c] in g's type. c must be even.
int yk_banded_gather_bwd(const void* g_own, const void* g_oth, const void* nptr,
                         const void* tperm, const void* tptr, void* dx, int n, int e,
                         int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n, WARPS);
  if (bf16)
    gather_bwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g_own), static_cast<const __nv_bfloat16*>(g_oth),
        static_cast<const int*>(nptr), static_cast<const int*>(tperm),
        static_cast<const int*>(tptr), static_cast<__nv_bfloat16*>(dx), n, e, c);
  else
    gather_bwd_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g_own), static_cast<const float*>(g_oth),
        static_cast<const int*>(nptr), static_cast<const int*>(tperm),
        static_cast<const int*>(tptr), static_cast<float*>(dx), n, e, c);
  return (int)cudaGetLastError();
}

// Kernel 8. rows [e, c] (f32 or bf16); nptr [n + 1] i32; out [n, c] f32. c
// must be even.
int yk_banded_scatter_own(const void* rows, const void* nptr, void* out, int n, int e,
                          int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n, WARPS);
  if (bf16)
    scatter_own_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(rows), static_cast<const int*>(nptr),
        static_cast<float*>(out), n, e, c);
  else
    scatter_own_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(rows), static_cast<const int*>(nptr),
        static_cast<float*>(out), n, e, c);
  return (int)cudaGetLastError();
}

// Kernel 8b. g [n, c] f32; own [e] i32; out [e, c] (f32, or bf16 when
// bf16 != 0).
int yk_banded_scatter_own_bwd(const void* g, const void* own, void* out, int n, int e,
                              int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for((long)e * c, THREADS);
  if (bf16)
    scatter_own_bwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const int*>(own),
        static_cast<__nv_bfloat16*>(out), n, e, c);
  else
    scatter_own_bwd_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const int*>(own),
        static_cast<float*>(out), n, e, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
