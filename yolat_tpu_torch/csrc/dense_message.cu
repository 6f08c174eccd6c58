// Fused dense-table conv: the canonical conv's folded-BN message MLP over a
// per-node neighbour table, masked mean, lin_r skip and bias, for sm_90a.
//
// Replaces: yolat_tpu/ops/pallas_kernels.py, fused_dense_message
// (`_fused_message_kernel`, pallas_call at :130). For every node i with
// neighbour slots k < D (nbr_idx [N, D], nbr_attr [N, D, A], nbr_mask [N, D]):
//   s_i  = x_i @ (W1a - W1b)
//   h1   = relu((x_nbr(i,k) @ W1b + attr(i,k) @ W1c + s_i) * sc1[0] + sc1[1])
//   h2   = relu((h1 @ W2) * sc2[0] + sc2[1]) * mask(i,k)
//   out_i = (sum_k h2) / max(sum_k mask, 1) + x_i @ Wr + br       (f32, [N, H])
// Rounding follows the TPU kernel: W1a - W1b is formed in f32 and then
// rounded to the input type (the wrapper does it); s_i, h1 and the masked h2
// are rounded to the input type before the next product or sum; products
// and sums are f32; sc1, sc2 and br are f32.
//
// What bounds it on the H100: arithmetic on the FP32 pipes. A used slot
// costs 2*(C+A)*64 + 2*64*64 flops against C values of x (L2 hits, mostly)
// and A attributes. The TPU kernel gathers x[nbr_idx] in XLA beforehand and
// expands s_i to the slot rows, and sums the slots back, by multiplying with
// a constant 0/1 matrix, because Mosaic cannot repeat or fold rows; here a
// thread that owns (node, column) keeps s_i, the slot sum and the count in
// registers, and rows are gathered straight from global memory:
//   * a CTA keeps the split W1, W2, Wr and the scale/shift pairs in shared
//     memory and walks over tiles of 32 nodes (a persistent loop, so the
//     weights are staged once per CTA, not once per tile);
//   * per tile: stage the nodes' x rows, form s_i and the skip (8 nodes x 1
//     column per thread), then per slot gather the neighbours' rows and
//     attributes and run both MLP stages from shared memory; a slot that no
//     node of the tile uses is skipped (the table is mostly padding);
//   * the slot sum runs over k = 0..D-1 in order in a register: no atomics,
//     bit-identical across runs; any N is taken, the last tile is masked.
// This first version is far below the FP32 peak (PERF.md); mma.sync / wgmma
// tiles are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int H = 64;            // message width (the conv's out channels)
constexpr int THREADS = 256;
constexpr int TN = 32;           // nodes per tile
constexpr int G = THREADS / H;   // node groups per tile
constexpr int NPT = TN / G;      // nodes per thread per tile

size_t smem_bytes(int c, int na) {
  size_t floats = (size_t)(3 * c + na) * H + H * H + 5 * H + (size_t)2 * TN * c +
                  (size_t)TN * na + (size_t)TN * H;
  return floats * 4 + 2 * TN * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) dense_message_kernel(
    const T* __restrict__ x, const int* __restrict__ nbr_idx,
    const float* __restrict__ nbr_attr, const uint8_t* __restrict__ nbr_mask,
    const T* __restrict__ w1s, const float* __restrict__ sc1,
    const T* __restrict__ w2, const float* __restrict__ sc2,
    const T* __restrict__ wr, const float* __restrict__ br,
    float* __restrict__ out, int n, int c, int d, int na, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1_s = reinterpret_cast<float*>(smem_raw);  // [2c+na, H]: W1a-W1b, W1b, W1c
  float* wr_s = w1_s + (2 * c + na) * H;             // [c, H]
  float* w2_s = wr_s + c * H;                        // [H, H]
  float* sc_s = w2_s + H * H;                        // [5, H]: sc1, sc2, br
  float* x_s = sc_s + 5 * H;                         // [TN, c] own rows
  float* xn_s = x_s + TN * c;                        // [TN, c] neighbour rows
  float* at_s = xn_s + TN * c;                       // [TN, na]
  float* h1_s = at_s + TN * na;                      // [TN, H]
  int* mk_s = reinterpret_cast<int*>(h1_s + TN * H);  // [TN] slot used
  int* ni_s = mk_s + TN;                             // [TN] neighbour row

  const int tid = threadIdx.x;
  for (int i = tid; i < (2 * c + na) * H; i += THREADS) w1_s[i] = yk::to_f(w1s[i]);
  for (int i = tid; i < c * H; i += THREADS) wr_s[i] = yk::to_f(wr[i]);
  for (int i = tid; i < H * H; i += THREADS) w2_s[i] = yk::to_f(w2[i]);
  for (int i = tid; i < 2 * H; i += THREADS) {
    sc_s[i] = sc1[i];
    sc_s[2 * H + i] = sc2[i];
  }
  for (int i = tid; i < H; i += THREADS) sc_s[4 * H + i] = br[i];

  const int g = tid / H, j = tid % H;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int node0 = tile * TN;
    // also the barrier after the weight staging and after the previous
    // tile's last reads of shared memory
    __syncthreads();
    for (int i = tid; i < TN * c; i += THREADS) {
      const int node = node0 + i / c;
      x_s[i] = node < n ? yk::to_f(x[(size_t)node0 * c + i]) : 0.f;
    }
    __syncthreads();

    float si[NPT], skip[NPT], agg[NPT], cnt[NPT];
#pragma unroll
    for (int r = 0; r < NPT; ++r) si[r] = skip[r] = agg[r] = cnt[r] = 0.f;
    for (int kk = 0; kk < c; ++kk) {
      const float wd = w1_s[kk * H + j], wk = wr_s[kk * H + j];
#pragma unroll
      for (int r = 0; r < NPT; ++r) {
        const float xv = x_s[(g + r * G) * c + kk];
        si[r] = fmaf(xv, wd, si[r]);
        skip[r] = fmaf(xv, wk, skip[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < NPT; ++r) si[r] = yk::round_to<T>(si[r]);

    for (int slot = 0; slot < d; ++slot) {
      int used = 0;
      if (tid < TN) {
        const int node = node0 + tid;
        used = node < n && nbr_mask[(size_t)node * d + slot] != 0;
        mk_s[tid] = used;
        // clamped for memory safety only: the table's rows lie in [0, n)
        ni_s[tid] = used ? min(max(nbr_idx[(size_t)node * d + slot], 0), n - 1) : 0;
      }
      // also the barrier between the previous slot's reads of xn_s / at_s /
      // h1_s and this slot's writes
      if (!__syncthreads_or(used)) continue;
      for (int i = tid; i < TN * c; i += THREADS) {
        const int nl = i / c;
        xn_s[i] = mk_s[nl] ? yk::to_f(x[(size_t)ni_s[nl] * c + (i - nl * c)]) : 0.f;
      }
      for (int i = tid; i < TN * na; i += THREADS) {
        const int nl = i / na;
        at_s[i] = mk_s[nl] ? yk::round_to<T>(nbr_attr[((size_t)(node0 + nl) * d + slot) * na +
                                                       (i - nl * na)])
                           : 0.f;
      }
      __syncthreads();

      // the slot's mask goes to registers here: the next slot rewrites mk_s
      // while slower threads are still in this slot's second stage
      float acc[NPT], m[NPT];
#pragma unroll
      for (int r = 0; r < NPT; ++r) {
        acc[r] = 0.f;
        m[r] = mk_s[g + r * G] ? 1.f : 0.f;
      }
      for (int kk = 0; kk < c; ++kk) {
        const float wb = w1_s[(c + kk) * H + j];
#pragma unroll
        for (int r = 0; r < NPT; ++r) acc[r] = fmaf(xn_s[(g + r * G) * c + kk], wb, acc[r]);
      }
      for (int a = 0; a < na; ++a) {
        const float wc = w1_s[(2 * c + a) * H + j];
#pragma unroll
        for (int r = 0; r < NPT; ++r) acc[r] = fmaf(at_s[(g + r * G) * na + a], wc, acc[r]);
      }
      {
        const float s0 = sc_s[j], s1 = sc_s[H + j];
#pragma unroll
        for (int r = 0; r < NPT; ++r)
          h1_s[(g + r * G) * H + j] =
              yk::round_to<T>(fmaxf((acc[r] + si[r]) * s0 + s1, 0.f));
      }
      __syncthreads();

#pragma unroll
      for (int r = 0; r < NPT; ++r) acc[r] = 0.f;
      for (int kk = 0; kk < H; ++kk) {
        const float w = w2_s[kk * H + j];
#pragma unroll
        for (int r = 0; r < NPT; ++r) acc[r] = fmaf(h1_s[(g + r * G) * H + kk], w, acc[r]);
      }
      {
        const float s0 = sc_s[2 * H + j], s1 = sc_s[3 * H + j];
#pragma unroll
        for (int r = 0; r < NPT; ++r) {
          agg[r] += yk::round_to<T>(fmaxf(acc[r] * s0 + s1, 0.f) * m[r]);
          cnt[r] += m[r];
        }
      }
    }

    const float bj = sc_s[4 * H + j];
#pragma unroll
    for (int r = 0; r < NPT; ++r) {
      const int node = node0 + g + r * G;
      if (node < n)
        out[(size_t)node * H + j] = agg[r] * (1.f / fmaxf(cnt[r], 1.f)) + skip[r] + bj;
    }
  }
}

template <typename T>
int launch(const void* x, const void* nbr_idx, const void* nbr_attr,
           const void* nbr_mask, const void* w1s, const void* sc1, const void* w2,
           const void* sc2, const void* wr, const void* br, void* out, int n,
           int c, int d, int na, int max_ctas, cudaStream_t stream) {
  const size_t smem = smem_bytes(c, na);
  cudaError_t err = cudaFuncSetAttribute(
      dense_message_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + TN - 1) / TN;
  const int grid = n_tiles < max_ctas ? n_tiles : max_ctas;
  dense_message_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(nbr_idx),
      static_cast<const float*>(nbr_attr), static_cast<const uint8_t*>(nbr_mask),
      static_cast<const T*>(w1s), static_cast<const float*>(sc1),
      static_cast<const T*>(w2), static_cast<const float*>(sc2),
      static_cast<const T*>(wr), static_cast<const float*>(br),
      static_cast<float*>(out), n, c, d, na, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, c] (f32, or bf16 when bf16 != 0); nbr_idx [n, d] i32; nbr_attr
// [n, d, na] f32; nbr_mask [n, d] bytes (0 or 1); w1s [2c+na, 64] in x's
// type with rows [W1a - W1b; W1b; W1c]; sc1/sc2 [2, 64] f32; w2 [64, 64] and
// wr [c, 64] in x's type; br [64] f32; out [n, 64] f32; max_ctas the grid
// cap (CTAs loop over node tiles). Returns the CUDA error code of the launch.
int yk_fused_dense_message(const void* x, const void* nbr_idx,
                           const void* nbr_attr, const void* nbr_mask,
                           const void* w1s, const void* sc1, const void* w2,
                           const void* sc2, const void* wr, const void* br,
                           void* out, int n, int c, int d, int na, int max_ctas,
                           int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, nbr_idx, nbr_attr, nbr_mask, w1s, sc1, w2,
                                 sc2, wr, br, out, n, c, d, na, max_ctas, st);
  return launch<float>(x, nbr_idx, nbr_attr, nbr_mask, w1s, sc1, w2, sc2, wr,
                       br, out, n, c, d, na, max_ctas, st);
}

// dynamic shared memory the launch asks for (bytes)
long yk_dense_message_smem_bytes(int c, int na) { return (long)smem_bytes(c, na); }

}  // extern "C"
