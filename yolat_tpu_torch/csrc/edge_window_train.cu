// Trainable edge-window ops for sm_90a: the pair-feature gather and the
// per-destination sum of the canonical conv's window layout, each with its
// backward (kernels 9 and 10); and, on kernel 10's two bodies, the per-node
// sum of the banded training route and its backward (kernels 8 and 8b).
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
// and yolat_tpu/ops/banded_train.py
//   banded_scatter_own  (_scatter_call with target_oth False, pallas_call at
//                        :257; its VJP _scatter_own_bwd :319 = _gather_impl,
//                        own only)
// which computes the same two functions over the banded plan
// (ops/plans.banded_plan): the rows sorted by `own` with offsets nptr in
// place of dst and dptr, so its entries launch the same kernels.
// Rounding follows the TPU kernels: x_j - x_i is taken in x's type;
// dg0 - dg1 is taken in dg's type before the f32 sum; dx is rounded to x's
// type at the end; the sum accumulates and returns f32; its backward rounds
// g to h's type. Per channel, a sum adds a node's in-edges in dptr order,
// then its out-edges in sperm order, left to right in f32.
//
// What bounds them on the H100: bytes. Each moves O(E * C) values once and
// does at most one add per value; there is no product, so nothing for the
// tensor cores, and TMA has no row gather (row_kernels.cuh holds the pieces
// and the choice of route). The TPU kernels turn every gather
// and its transpose into one-hot MXU contractions over a 3-window band of
// capacity-padded windows, because a TPU has no fast row gather and no
// scatter; Hopper reads rows directly, over the real edges only. The design
// is about Hopper's memory system:
//   * 16-byte route (VEC; a row is a whole number of 16-byte pieces, at
//     most 32 of them, and every value array starts on a 16-byte
//     boundary): a row is split into pieces of 8 bf16 or 4 f32 channels, and
//     a group of 2^lg lanes (the least power of two >= the pieces in a row)
//     serves one edge row (9 forward, 10 backward) or one node row (9
//     backward, 10 forward). The group reads its row's indices once, one
//     broadcast load per index for all its lanes (the one-thread-per-element
//     kernels reloaded them for every channel), and every value piece by
//     one ld.global.nc 16-byte load; it stores 16-byte pieces. All index
//     arithmetic is int (the wrappers hold e * 2c and n * c below 2^31).
//     The sums keep 8 or 4 f32 accumulators a lane and
//     walk their edge lists two rows at a time, so that two pieces (and,
//     through sperm, the next row's index) are in flight before the first
//     is added; the adds stay in list order.
//   * narrow route (rows of 5 or 1 channels, or a view whose data is not
//     16-byte aligned): one thread per row and a loop over the channels, in
//     int; kernel 9's forward one thread per (row, channel), in int.
// The C entries choose the route from c, the type and the pointers.
// Every output row is written once, by one group or thread, in a fixed
// order: no float atomics, bit-identical across runs and to the one-thread-
// per-element kernels this design replaced.
#include "row_kernels.cuh"

namespace {

// acc += round_to<T>(a - b), channel by channel
template <typename T>
__device__ __forceinline__ void add_diff(float (&acc)[Piece<T>::K], const uint4& a,
                                         const uint4& b) {
  float fa[Piece<T>::K], fb[Piece<T>::K];
  unpack(a, fa);
  unpack(b, fb);
#pragma unroll
  for (int k = 0; k < Piece<T>::K; ++k) acc[k] += yk::round_to<T>(fa[k] - fb[k]);
}

// ---- the kernels: VEC the 16-byte route, else the narrow route ----
// lg: log2 of the lanes a row's group has (16-byte route). Rows are clamped
// into range for memory safety only: edge_window_plan rejects endpoints
// outside [0, n).

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) pair_fwd_kernel(
    const T* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ dst, T* __restrict__ g, int n, int e, int c,
    int lg) {
  if constexpr (VEC) {
    const int p = c / Piece<T>::K, pc = threadIdx.x & ((1 << lg) - 1);
    const int per = THREADS >> lg;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* gv = reinterpret_cast<uint4*>(g);
    for (int r = blockIdx.x * per + (threadIdx.x >> lg); r < e; r += gridDim.x * per) {
      if (pc >= p) continue;
      const int i = clampi(__ldg(dst + r), n - 1), j = clampi(__ldg(src + r), n - 1);
      const uint4 a = ld16(xv + i * p + pc), b = ld16(xv + j * p + pc);
      float fa[Piece<T>::K], fb[Piece<T>::K];
      unpack(a, fa);
      unpack(b, fb);
#pragma unroll
      for (int k = 0; k < Piece<T>::K; ++k) fb[k] -= fa[k];
      gv[r * 2 * p + pc] = a;
      gv[r * 2 * p + p + pc] = pack<T>(fb);
    }
  } else {
    // one thread per (row, channel)
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < e * c; i += gridDim.x * THREADS) {
      const int r = i / c, k = i - r * c;
      const T xi = x[clampi(__ldg(dst + r), n - 1) * c + k];
      const float xj = yk::to_f(x[clampi(__ldg(src + r), n - 1) * c + k]);
      g[r * 2 * c + k] = xi;
      g[r * 2 * c + c + k] = yk::from_f<T>(xj - yk::to_f(xi));
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) pair_bwd_kernel(
    const T* __restrict__ dg, const int* __restrict__ dptr,
    const int* __restrict__ sperm, const int* __restrict__ sptr,
    T* __restrict__ dx, int n, int e, int c, int lg) {
  if constexpr (VEC) {
    constexpr int K = Piece<T>::K;
    const int p = c / K, pc = threadIdx.x & ((1 << lg) - 1);
    const int per = THREADS >> lg;
    // piece pc of row ee's dg0 half at in[ee * 2p], of its dg1 half at + p
    const uint4* in = reinterpret_cast<const uint4*>(dg) + pc;
    for (int v = blockIdx.x * per + (threadIdx.x >> lg); v < n; v += gridDim.x * per) {
      if (pc >= p) continue;
      const int d0 = clampi(__ldg(dptr + v), e), d1 = clampi(__ldg(dptr + v + 1), e);
      const int s0 = clampi(__ldg(sptr + v), e), s1 = clampi(__ldg(sptr + v + 1), e);
      // the first two out-edge rows, loaded beside the in-edge pieces
      int q = s0;
      int r0 = q < s1 ? clampi(__ldg(sperm + q), e - 1) : 0;
      int r1 = q + 1 < s1 ? clampi(__ldg(sperm + q + 1), e - 1) : 0;
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.f;
      int ee = d0;
      for (; ee + 1 < d1; ee += 2) {
        const uint4 a0 = ld16(in + ee * 2 * p), b0 = ld16(in + ee * 2 * p + p);
        const uint4 a1 = ld16(in + (ee + 1) * 2 * p), b1 = ld16(in + (ee + 1) * 2 * p + p);
        add_diff<T>(acc, a0, b0);
        add_diff<T>(acc, a1, b1);
      }
      if (ee < d1) add_diff<T>(acc, ld16(in + ee * 2 * p), ld16(in + ee * 2 * p + p));
      for (; q + 1 < s1; q += 2) {
        const uint4 b0 = ld16(in + r0 * 2 * p + p), b1 = ld16(in + r1 * 2 * p + p);
        // the next two rows' indices before this pair is added
        r0 = q + 2 < s1 ? clampi(__ldg(sperm + q + 2), e - 1) : 0;
        r1 = q + 3 < s1 ? clampi(__ldg(sperm + q + 3), e - 1) : 0;
        add_piece<T>(acc, b0);
        add_piece<T>(acc, b1);
      }
      if (q < s1) add_piece<T>(acc, ld16(in + r0 * 2 * p + p));
      reinterpret_cast<uint4*>(dx)[v * p + pc] = pack<T>(acc);
    }
  } else {
    constexpr int CH = 8;  // channels a thread sums at once
    for (int v = blockIdx.x * THREADS + threadIdx.x; v < n; v += gridDim.x * THREADS) {
      const int d0 = clampi(dptr[v], e), d1 = clampi(dptr[v + 1], e);
      const int s0 = clampi(sptr[v], e), s1 = clampi(sptr[v + 1], e);
      for (int k0 = 0; k0 < c; k0 += CH) {
        float acc[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) acc[j] = 0.f;
        for (int ee = d0; ee < d1; ++ee) {
          const T* row = dg + ee * 2 * c + k0;
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (k0 + j < c)
              acc[j] += yk::round_to<T>(yk::to_f(row[j]) - yk::to_f(row[c + j]));
        }
        for (int q = s0; q < s1; ++q) {
          const T* row = dg + clampi(sperm[q], e - 1) * 2 * c + c + k0;
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (k0 + j < c) acc[j] += yk::to_f(row[j]);
        }
#pragma unroll
        for (int j = 0; j < CH; ++j)
          if (k0 + j < c) dx[v * c + k0 + j] = yk::from_f<T>(acc[j]);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) wsum_fwd_kernel(
    const T* __restrict__ h, const int* __restrict__ dptr,
    float* __restrict__ out, int n, int e, int c, int lg) {
  if constexpr (VEC) {
    constexpr int K = Piece<T>::K;
    const int p = c / K, pc = threadIdx.x & ((1 << lg) - 1);
    const int per = THREADS >> lg;
    const uint4* in = reinterpret_cast<const uint4*>(h) + pc;
    for (int v = blockIdx.x * per + (threadIdx.x >> lg); v < n; v += gridDim.x * per) {
      if (pc >= p) continue;
      const int d0 = clampi(__ldg(dptr + v), e), d1 = clampi(__ldg(dptr + v + 1), e);
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.f;
      int ee = d0;
      for (; ee + 1 < d1; ee += 2) {
        const uint4 a0 = ld16(in + ee * p), a1 = ld16(in + (ee + 1) * p);
        add_piece<T>(acc, a0);
        add_piece<T>(acc, a1);
      }
      if (ee < d1) add_piece<T>(acc, ld16(in + ee * p));
      // K f32 channels: K / 4 16-byte stores (a zero row too)
      float4* o = reinterpret_cast<float4*>(out) + (v * p + pc) * (K / 4);
#pragma unroll
      for (int s = 0; s < K / 4; ++s)
        o[s] = make_float4(acc[4 * s], acc[4 * s + 1], acc[4 * s + 2], acc[4 * s + 3]);
    }
  } else {
    constexpr int CH = 8;
    for (int v = blockIdx.x * THREADS + threadIdx.x; v < n; v += gridDim.x * THREADS) {
      const int d0 = clampi(dptr[v], e), d1 = clampi(dptr[v + 1], e);
      for (int k0 = 0; k0 < c; k0 += CH) {
        float acc[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) acc[j] = 0.f;
        for (int ee = d0; ee < d1; ++ee) {
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (k0 + j < c) acc[j] += yk::to_f(h[ee * c + k0 + j]);
        }
#pragma unroll
        for (int j = 0; j < CH; ++j)
          if (k0 + j < c) out[v * c + k0 + j] = acc[j];
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) wsum_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ dst,
    T* __restrict__ dh, int n, int e, int c, int lg) {
  if constexpr (VEC) {
    constexpr int K = Piece<T>::K;
    const int p = c / K, pc = threadIdx.x & ((1 << lg) - 1);
    const int per = THREADS >> lg;
    for (int r = blockIdx.x * per + (threadIdx.x >> lg); r < e; r += gridDim.x * per) {
      if (pc >= p) continue;
      const int i = clampi(__ldg(dst + r), n - 1);
      // K f32 channels of g's row i: K / 4 16-byte loads
      const uint4* gi = reinterpret_cast<const uint4*>(g) + (i * p + pc) * (K / 4);
      float f[K];
#pragma unroll
      for (int s = 0; s < K / 4; ++s) {
        float q[4];
        unpack(ld16(gi + s), q);
#pragma unroll
        for (int k = 0; k < 4; ++k) f[4 * s + k] = q[k];
      }
      reinterpret_cast<uint4*>(dh)[r * p + pc] = pack<T>(f);
    }
  } else {
    for (int r = blockIdx.x * THREADS + threadIdx.x; r < e; r += gridDim.x * THREADS) {
      const int i = clampi(dst[r], n - 1);
      for (int k = 0; k < c; ++k) dh[r * c + k] = yk::from_f<T>(g[i * c + k]);
    }
  }
}

template <typename T>
int pair_fwd(const void* x, const void* src, const void* dst, void* g, int n,
             int e, int c, cudaStream_t st) {
  return launch<T>(pair_fwd_kernel<T, true>, pair_fwd_kernel<T, false>, {x, g}, e,
                   e * c, c, st, static_cast<const T*>(x), static_cast<const int*>(src),
                   static_cast<const int*>(dst), static_cast<T*>(g), n, e, c);
}

template <typename T>
int pair_bwd(const void* dg, const void* dptr, const void* sperm,
             const void* sptr, void* dx, int n, int e, int c, cudaStream_t st) {
  return launch<T>(pair_bwd_kernel<T, true>, pair_bwd_kernel<T, false>, {dg, dx}, n, n,
                   c, st, static_cast<const T*>(dg), static_cast<const int*>(dptr),
                   static_cast<const int*>(sperm), static_cast<const int*>(sptr),
                   static_cast<T*>(dx), n, e, c);
}

template <typename T>
int wsum_fwd(const void* h, const void* dptr, void* out, int n, int e, int c,
             cudaStream_t st) {
  return launch<T>(wsum_fwd_kernel<T, true>, wsum_fwd_kernel<T, false>, {h, out}, n, n,
                   c, st, static_cast<const T*>(h), static_cast<const int*>(dptr),
                   static_cast<float*>(out), n, e, c);
}

template <typename T>
int wsum_bwd(const void* g, const void* dst, void* dh, int n, int e, int c,
             cudaStream_t st) {
  return launch<T>(wsum_bwd_kernel<T, true>, wsum_bwd_kernel<T, false>, {g, dh}, e, e,
                   c, st, static_cast<const float*>(g), static_cast<const int*>(dst),
                   static_cast<T*>(dh), n, e, c);
}

}  // namespace

extern "C" {

// Each returns the CUDA error code of its launch.

// x [n, c] (f32, or bf16 when bf16 != 0); src/dst [e] i32; g [e, 2c] in x's
// type.
int yk_ew_pair_fwd(const void* x, const void* src, const void* dst, void* g,
                   int n, int e, int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? pair_fwd<__nv_bfloat16>(x, src, dst, g, n, e, c, st)
              : pair_fwd<float>(x, src, dst, g, n, e, c, st);
}

// dg [e, 2c] (f32 or bf16); dptr/sptr [n + 1] i32; sperm [e] i32; dx [n, c]
// in dg's type.
int yk_ew_pair_bwd(const void* dg, const void* dptr, const void* sperm,
                   const void* sptr, void* dx, int n, int e, int c, int bf16,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? pair_bwd<__nv_bfloat16>(dg, dptr, sperm, sptr, dx, n, e, c, st)
              : pair_bwd<float>(dg, dptr, sperm, sptr, dx, n, e, c, st);
}

// h [e, c] (f32 or bf16); dptr [n + 1] i32; out [n, c] f32.
int yk_ew_wsum_fwd(const void* h, const void* dptr, void* out, int n, int e,
                   int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? wsum_fwd<__nv_bfloat16>(h, dptr, out, n, e, c, st)
              : wsum_fwd<float>(h, dptr, out, n, e, c, st);
}

// g [n, c] f32; dst [e] i32; dh [e, c] (f32, or bf16 when bf16 != 0).
int yk_ew_wsum_bwd(const void* g, const void* dst, void* dh, int n, int e,
                   int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? wsum_bwd<__nv_bfloat16>(g, dst, dh, n, e, c, st)
              : wsum_bwd<float>(g, dst, dh, n, e, c, st);
}

// Kernel 8 (banded_scatter_own): kernel 10's forward over the banded plan.
// rows [e, c] (f32 or bf16); nptr [n + 1] i32; out [n, c] f32.
int yk_banded_scatter_own(const void* rows, const void* nptr, void* out, int n,
                          int e, int c, int bf16, void* stream) {
  return yk_ew_wsum_fwd(rows, nptr, out, n, e, c, bf16, stream);
}

// Kernel 8b (its VJP): kernel 10's backward with `own` for dst. g [n, c]
// f32; own [e] i32; out [e, c] (f32, or bf16 when bf16 != 0).
int yk_banded_scatter_own_bwd(const void* g, const void* own, void* out, int n,
                              int e, int c, int bf16, void* stream) {
  return yk_ew_wsum_bwd(g, own, out, n, e, c, bf16, stream);
}

}  // extern "C"
