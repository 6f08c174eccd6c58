// Edge-window message sum: the canonical conv's folded-BN message MLP,
// summed per destination node, for sm_90a.
//
// Replaces: yolat_tpu/ops/edge_window.py, edge_window_message_sum
// (`_kernel`, pallas_call at :234). For every real edge e = (src, dst) of
// the pack-time plan (ops/plans.edge_window_plan: dst-sorted, absolute node
// rows, window offsets wptr):
//   h1 = relu((x_dst @ (W1a - W1b) + x_src @ W1b + attr @ W1c) * sc1[0] + sc1[1])
//   h2 = relu((h1 @ W2) * sc2[0] + sc2[1])
//   out[dst] = sum over the node's in-edges of h2        (f32, [N, H])
// Rounding follows the TPU kernel: W1 is split in the input type,
// x_i/x_j/attr, h1 and h2 are rounded to the input type, products and sums
// are f32.
//
// What bounds it on the H100: the per-edge MLP is 2*(2C+4)*64 + 2*64*64
// flops (25 kFLOP at C=64) against 2*C values of x per edge, mostly L2
// hits — arithmetic, not HBM bytes. The TPU kernel turned the gathers into
// one-hot MXU contractions over a 3-window band of x padded to a fixed
// edge capacity per window, because a TPU has no fast row gather; Hopper
// gathers rows directly, so this design drops the one-hot matrices, the
// band and the capacity:
//   * one CTA per window of WN destination nodes holds W1 (pre-split), W2
//     and the scale/shift pairs in shared memory for all of its edges;
//   * the window's edges stream through in tiles of 32, however many there
//     are: a tile's x_i / x_j rows are gathered straight from global memory
//     (L2 serves the neighbourhood overlap), then each thread computes 8
//     edges x 1 output column of each stage from shared memory;
//   * a [WN, 64] f32 accumulator in shared memory takes each tile's h2
//     rows: one thread per column adds them in edge order, so a node's sum
//     is formed in the plan's order — no float atomics, bit-identical
//     across runs — and every output row of the window is written once.
// This first version runs on the FP32 pipes at one CTA (8 warps) per SM —
// the accumulator takes most of shared memory — far below the FP32 peak
// (PERF.md); mma.sync / wgmma tiles are later work.
//
// Decomposition variants (yk_edge_window_decomp). Replaces:
// scripts/ew_kernel_decomp.py, the probe kernel `main.make.kern` (:41-86,
// pallas_call at :105), which times kernel 1 at C = H = 64 with parts of
// its work switched off. The variant is a template parameter of the same
// kernel, so everything but the tile's row loads is the code above:
//   full      today's kernel (yk_edge_window_message_sum launches this
//             instantiation; the same code, the same bits);
//   noband    the source-row gather is off: a tile loads x[dst] only and
//             stores it as both x_i and x_j — what the probe's noband
//             computes (ohs = ohl, so x_j = x_i). Kernel 1 on the plan
//             with src := dst gives the same bits;
//   noonehot  both row gathers are off: x_i and x_j are the constant
//             0.001 rounded to the input type, and no row of x is read.
//             Kernel 1 on x filled with 0.001 gives the same bits. The
//             probe's noonehot replaces both one-hot matrices by 0.001, so
//             its x_i / x_j are 0.001-scaled window sums, over its 3-window
//             band only, and its output is numerically meaningless; this
//             variant keeps the probe's point, everything but the row
//             selection, and computes a defined function.
// attr, the plan's dst, the MLP and the per-destination sum are the same in
// every variant, and so is the shared memory a launch asks for.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int H = 64;             // message width (the conv's out channels)
constexpr int THREADS = 256;
constexpr int TE = 32;            // edges per tile
constexpr int G = THREADS / H;    // edge groups per tile
constexpr int EPT = TE / G;       // edges per thread per tile

enum Variant : int { kFull = 0, kNoBand = 1, kNoOneHot = 2 };

size_t smem_bytes(int c, int na, int wn) {
  size_t floats = (size_t)(2 * c + na) * H + H * H + 4 * H + (size_t)2 * TE * c +
                  (size_t)TE * na + (size_t)2 * TE * H + (size_t)wn * H;
  return floats * 4 + TE * 4;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) edge_window_kernel(
    const T* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ dst, const float* __restrict__ attr,
    const int* __restrict__ wptr, const T* __restrict__ w1s,
    const float* __restrict__ sc1, const T* __restrict__ w2,
    const float* __restrict__ sc2, float* __restrict__ out, int n, int c,
    int wn, int na) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1_s = reinterpret_cast<float*>(smem_raw);  // [2c+na, H]
  float* w2_s = w1_s + (2 * c + na) * H;             // [H, H]
  float* sc_s = w2_s + H * H;                        // [4, H]: sc1, sc2
  float* xi_s = sc_s + 4 * H;                        // [TE, c]
  float* xj_s = xi_s + TE * c;                       // [TE, c]
  float* at_s = xj_s + TE * c;                       // [TE, na]
  float* h1_s = at_s + TE * na;                      // [TE, H]
  float* h2_s = h1_s + TE * H;                       // [TE, H]
  float* acc_s = h2_s + TE * H;                      // [wn, H]
  int* dl_s = reinterpret_cast<int*>(acc_s + wn * H);  // [TE] local dst, -1 past the end

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int node0 = k * wn;
  const int nodes = min(wn, n - node0);
  const int e_begin = wptr[k], e_end = wptr[k + 1];

  for (int i = tid; i < (2 * c + na) * H; i += THREADS) w1_s[i] = yk::to_f(w1s[i]);
  for (int i = tid; i < H * H; i += THREADS) w2_s[i] = yk::to_f(w2[i]);
  for (int i = tid; i < 2 * H; i += THREADS) {
    sc_s[i] = sc1[i];
    sc_s[2 * H + i] = sc2[i];
  }
  for (int i = tid; i < wn * H; i += THREADS) acc_s[i] = 0.f;

  const int g = tid / H, j = tid % H;
  for (int e0 = e_begin; e0 < e_end; e0 += TE) {
    // also the barrier between the previous tile's aggregation and this
    // tile's shared-memory writes
    __syncthreads();
    // rows are clamped into [0, n) for memory safety only: the plan builder
    // rejects endpoints outside it
    for (int i = tid; i < TE * c; i += THREADS) {
      const int el = i / c, kk = i - el * c, e = e0 + el;
      float xi = 0.f, xj = 0.f;
      if (e < e_end) {
        if constexpr (V == kNoOneHot) {
          xi = xj = yk::round_to<T>(0.001f);
        } else {
          xi = yk::to_f(x[(size_t)min(max(dst[e], 0), n - 1) * c + kk]);
          if constexpr (V == kNoBand)
            xj = xi;
          else
            xj = yk::to_f(x[(size_t)min(max(src[e], 0), n - 1) * c + kk]);
        }
      }
      xi_s[i] = xi;
      xj_s[i] = xj;
    }
    for (int i = tid; i < TE * na; i += THREADS)
      at_s[i] = e0 + i / na < e_end ? yk::round_to<T>(attr[(size_t)e0 * na + i]) : 0.f;
    if (tid < TE)
      dl_s[tid] = e0 + tid < e_end ? min(max(dst[e0 + tid] - node0, 0), wn - 1) : -1;
    __syncthreads();

    float acc[EPT];
#pragma unroll
    for (int r = 0; r < EPT; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < c; ++kk) {
      const float wd = w1_s[kk * H + j], wb = w1_s[(c + kk) * H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r) {
        const int el = g + r * G;
        acc[r] = fmaf(xi_s[el * c + kk], wd, acc[r]);
        acc[r] = fmaf(xj_s[el * c + kk], wb, acc[r]);
      }
    }
    for (int a = 0; a < na; ++a) {
      const float wc = w1_s[(2 * c + a) * H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r) acc[r] = fmaf(at_s[(g + r * G) * na + a], wc, acc[r]);
    }
    {
      const float s0 = sc_s[j], s1 = sc_s[H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r)
        h1_s[(g + r * G) * H + j] = yk::round_to<T>(fmaxf(acc[r] * s0 + s1, 0.f));
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < EPT; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < H; ++kk) {
      const float w = w2_s[kk * H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r) acc[r] = fmaf(h1_s[(g + r * G) * H + kk], w, acc[r]);
    }
    {
      const float s0 = sc_s[2 * H + j], s1 = sc_s[3 * H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r)
        h2_s[(g + r * G) * H + j] = yk::round_to<T>(fmaxf(acc[r] * s0 + s1, 0.f));
    }
    __syncthreads();

    // one thread per column adds the tile's rows in edge order
    if (tid < H) {
      for (int el = 0; el < TE; ++el) {
        const int d = dl_s[el];
        if (d >= 0) acc_s[d * H + tid] += h2_s[el * H + tid];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nodes * H; i += THREADS) out[(size_t)node0 * H + i] = acc_s[i];
}

template <typename T, int V>
int launch(const void* x, const void* src, const void* dst, const void* attr,
           const void* wptr, const void* w1s, const void* sc1, const void* w2,
           const void* sc2, void* out, int n, int c, int nw, int wn, int na,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(c, na, wn);
  // the attribute belongs to each instantiation
  cudaError_t err = cudaFuncSetAttribute(
      edge_window_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_window_kernel<T, V><<<nw, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const float*>(attr),
      static_cast<const int*>(wptr), static_cast<const T*>(w1s),
      static_cast<const float*>(sc1), static_cast<const T*>(w2),
      static_cast<const float*>(sc2), static_cast<float*>(out), n, c, wn, na);
  return (int)cudaGetLastError();
}

template <int V>
int launch_typed(const void* x, const void* src, const void* dst,
                 const void* attr, const void* wptr, const void* w1s,
                 const void* sc1, const void* w2, const void* sc2, void* out,
                 int n, int c, int nw, int wn, int na, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, V>(x, src, dst, attr, wptr, w1s, sc1, w2, sc2,
                                    out, n, c, nw, wn, na, st);
  return launch<float, V>(x, src, dst, attr, wptr, w1s, sc1, w2, sc2, out, n,
                          c, nw, wn, na, st);
}

}  // namespace

extern "C" {

// x [n, c] (f32, or bf16 when bf16 != 0); src/dst [E] i32 (dst ascending);
// attr [E, na] f32; wptr [nw + 1] i32, nw = ceil(n / wn); w1s [2c+na, 64]
// in x's type with rows [W1a - W1b; W1b; W1c]; sc1/sc2 [2, 64] f32;
// w2 [64, 64] in x's type; out [n, 64] f32. Returns the CUDA error code of
// the launch.
int yk_edge_window_message_sum(const void* x, const void* src, const void* dst,
                               const void* attr, const void* wptr,
                               const void* w1s, const void* sc1, const void* w2,
                               const void* sc2, void* out, int n, int c, int nw,
                               int wn, int na, int bf16, void* stream) {
  return launch_typed<kFull>(x, src, dst, attr, wptr, w1s, sc1, w2, sc2, out,
                             n, c, nw, wn, na, bf16, stream);
}

// The decomposition probe's variants: 0 full, 1 noband, 2 noonehot (see the
// header); arguments as above. An unknown variant returns
// cudaErrorInvalidValue and launches nothing.
int yk_edge_window_decomp(int variant, const void* x, const void* src,
                          const void* dst, const void* attr, const void* wptr,
                          const void* w1s, const void* sc1, const void* w2,
                          const void* sc2, void* out, int n, int c, int nw,
                          int wn, int na, int bf16, void* stream) {
  switch (variant) {
    case kFull:
      return launch_typed<kFull>(x, src, dst, attr, wptr, w1s, sc1, w2, sc2,
                                 out, n, c, nw, wn, na, bf16, stream);
    case kNoBand:
      return launch_typed<kNoBand>(x, src, dst, attr, wptr, w1s, sc1, w2, sc2,
                                   out, n, c, nw, wn, na, bf16, stream);
    case kNoOneHot:
      return launch_typed<kNoOneHot>(x, src, dst, attr, wptr, w1s, sc1, w2,
                                     sc2, out, n, c, nw, wn, na, bf16, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory the launch asks for (bytes)
long yk_edge_window_smem_bytes(int c, int na, int wn) {
  return (long)smem_bytes(c, na, wn);
}

const char* yk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
