// Trainable edge-window ops for sm_90a: the pair-feature gather and the
// per-destination sum of the canonical conv's window layout, each with its
// backward.
//
// Replaces: yolat_tpu/ops/edge_window_train.py
//   ew_pair_features          (_pair_fwd, pallas_call at :127; _pair_bwd, :153)
//   ew_window_segment_sum_n   (_wsum_fwd, pallas_call at :245; _wsum_bwd, :270)
// over the plan of ops/plans.edge_window_plan(transpose=True): E real edges
// (src, dst), dst ascending; dptr [n + 1] the per-node offsets of that
// list; sperm [E] the edge rows stably sorted by source and sptr [n + 1]
// its per-node offsets.
//   pair forward   g[e] = [x[dst e] || x[src e] - x[dst e]]       (x's type)
//   pair backward  dx[v] = sum_{dst e = v} (dg0[e] - dg1[e])
//                        + sum_{src e = v} dg1[e]                 (x's type)
//   sum forward    out[v] = sum_{dst e = v} h[e]                  (f32)
//   sum backward   dh[e] = g[dst e]                               (h's type)
// Rounding follows the TPU kernels: x_j - x_i is taken in x's type;
// dg0 - dg1 is taken in dg's type before the f32 sum; dx is rounded to x's
// type at the end; the sum accumulates and returns f32; its backward rounds
// g to h's type.
//
// What bounds them on the H100: bytes. Each moves O(E * C) values once and
// does one add per value. The TPU kernels turn every gather and its
// transpose into one-hot MXU contractions over a 3-window band of
// capacity-padded windows, because a TPU has no fast row gather and no
// scatter; Hopper reads rows directly, so each kernel here is one thread per
// output element (consecutive threads on consecutive channels of one row:
// coalesced row reads and writes) over the real edges only. The sums run in
// the plan's fixed order (a node's in-edges, then its out-edges in sperm
// order), in registers: no float atomics, bit-identical across runs.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

int blocks_for(long total) {
  long b = (total + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// rows are clamped into range for memory safety only: edge_window_plan
// rejects endpoints outside [0, n)
template <typename T>
__global__ void __launch_bounds__(THREADS) pair_fwd_kernel(
    const T* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ dst, T* __restrict__ g, int n, int e, int c) {
  const long total = (long)e * c;
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const int ee = (int)(i / c), k = (int)(i - (long)ee * c);
    const T xi = x[(size_t)clampi(dst[ee], n - 1) * c + k];
    const float xj = yk::to_f(x[(size_t)clampi(src[ee], n - 1) * c + k]);
    g[(size_t)ee * 2 * c + k] = xi;
    g[(size_t)ee * 2 * c + c + k] = yk::from_f<T>(xj - yk::to_f(xi));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pair_bwd_kernel(
    const T* __restrict__ dg, const int* __restrict__ dptr,
    const int* __restrict__ sperm, const int* __restrict__ sptr,
    T* __restrict__ dx, int n, int e, int c) {
  const long total = (long)n * c;
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const int v = (int)(i / c), k = (int)(i - (long)v * c);
    float acc = 0.f;
    const int d0 = clampi(dptr[v], e), d1 = clampi(dptr[v + 1], e);
    for (int ee = d0; ee < d1; ++ee) {
      const size_t row = (size_t)ee * 2 * c;
      acc += yk::round_to<T>(yk::to_f(dg[row + k]) - yk::to_f(dg[row + c + k]));
    }
    const int s0 = clampi(sptr[v], e), s1 = clampi(sptr[v + 1], e);
    for (int q = s0; q < s1; ++q)
      acc += yk::to_f(dg[(size_t)clampi(sperm[q], e - 1) * 2 * c + c + k]);
    dx[i] = yk::from_f<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wsum_fwd_kernel(
    const T* __restrict__ h, const int* __restrict__ dptr,
    float* __restrict__ out, int n, int e, int c) {
  const long total = (long)n * c;
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const int v = (int)(i / c), k = (int)(i - (long)v * c);
    float acc = 0.f;
    const int d0 = clampi(dptr[v], e), d1 = clampi(dptr[v + 1], e);
    for (int ee = d0; ee < d1; ++ee) acc += yk::to_f(h[(size_t)ee * c + k]);
    out[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wsum_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ dst,
    T* __restrict__ dh, int n, int e, int c) {
  const long total = (long)e * c;
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const int ee = (int)(i / c), k = (int)(i - (long)ee * c);
    dh[i] = yk::from_f<T>(g[(size_t)clampi(dst[ee], n - 1) * c + k]);
  }
}

}  // namespace

extern "C" {

// x [n, c] (f32, or bf16 when bf16 != 0); src/dst [e] i32; g [e, 2c] in x's
// type. Each returns the CUDA error code of its launch.
int yk_ew_pair_fwd(const void* x, const void* src, const void* dst, void* g,
                   int n, int e, int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for((long)e * c);
  if (bf16)
    pair_fwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(src),
        static_cast<const int*>(dst), static_cast<__nv_bfloat16*>(g), n, e, c);
  else
    pair_fwd_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int*>(src),
        static_cast<const int*>(dst), static_cast<float*>(g), n, e, c);
  return (int)cudaGetLastError();
}

// dg [e, 2c] (f32 or bf16); dptr/sptr [n + 1] i32; sperm [e] i32; dx [n, c]
// in dg's type.
int yk_ew_pair_bwd(const void* dg, const void* dptr, const void* sperm,
                   const void* sptr, void* dx, int n, int e, int c, int bf16,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for((long)n * c);
  if (bf16)
    pair_bwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dg), static_cast<const int*>(dptr),
        static_cast<const int*>(sperm), static_cast<const int*>(sptr),
        static_cast<__nv_bfloat16*>(dx), n, e, c);
  else
    pair_bwd_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(dg), static_cast<const int*>(dptr),
        static_cast<const int*>(sperm), static_cast<const int*>(sptr),
        static_cast<float*>(dx), n, e, c);
  return (int)cudaGetLastError();
}

// h [e, c] (f32 or bf16); dptr [n + 1] i32; out [n, c] f32.
int yk_ew_wsum_fwd(const void* h, const void* dptr, void* out, int n, int e,
                   int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for((long)n * c);
  if (bf16)
    wsum_fwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const int*>(dptr),
        static_cast<float*>(out), n, e, c);
  else
    wsum_fwd_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(h), static_cast<const int*>(dptr),
        static_cast<float*>(out), n, e, c);
  return (int)cudaGetLastError();
}

// g [n, c] f32; dst [e] i32; dh [e, c] (f32, or bf16 when bf16 != 0).
int yk_ew_wsum_bwd(const void* g, const void* dst, void* dh, int n, int e,
                   int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for((long)e * c);
  if (bf16)
    wsum_bwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const int*>(dst),
        static_cast<__nv_bfloat16*>(dh), n, e, c);
  else
    wsum_bwd_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const int*>(dst),
        static_cast<float*>(dh), n, e, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
