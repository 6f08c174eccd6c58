// Banded message sums: a folded-BN message MLP over one edge family, summed
// per node at one endpoint (kernel 5) or at both (kernel 6), for sm_90a.
//
// Replaces: yolat_tpu/ops/banded_message.py, banded_message_sum (`_kernel`
// :181, pallas_call at :325) and banded_message_sum_both (`_kernel_both`
// :335, pallas_call at :477 with the spill-tile combination at :486-494).
// For every edge row r of the plan (ops/plans.banded_plan / bm_of: the
// family's real edges sorted by the endpoint `own`, absolute node rows,
// per-node offsets nptr, node ranges per thread block):
//   p_own = round(x[own] @ W_own),  p_oth = round(x[oth] @ W_halo)
//   h = relu(((p_own + p_oth) + round(attr) @ W_attr) * sc1[0] + sc1[1])
//   [second stage: h = relu((round(h) @ W2) * sc2[0] + sc2[1])]
//   out[own]    += round(h)                       (f32, [N, 64])
//   out_oth[oth] += round(h)   (kernel 6 only, single stage)
// round() is to x's type (f32: the identity), products and sums are f32:
// the TPU kernel's rounding points (it gathers pre-projected band rows in
// x's type, :199-204, and casts h before every sum, :240, :247, :387).
//
// What bounds it on the H100: 2*(2C+4)*64 flops per edge (17 kFLOP at
// C = 64) against two gathered rows of x that mostly hit L2 — arithmetic,
// not HBM bytes. The TPU kernel is built around the lack of a row gather:
// ragged 512-row edge blocks assigned to 512-node windows, a 3-part x band
// with 128-row halos, one-hot MXU contractions against pre-projected band
// rows, spill tiles for the other endpoint's sums. Hopper gathers rows, so
// none of that is carried over:
//   * a thread block takes a range of nodes and their edges, contiguous in
//     the sorted list. The ranges come from the plan: windows of wn nodes
//     for the near-uniform conv edge family, or cuts of about equal
//     edges + nodes that never split a node for the skewed clique family
//     (dense cliques next to empty stretches);
//   * the range's edges stream through in tiles of 32: both endpoint rows
//     are gathered from global memory, each thread computes 8 edges x 1
//     column from weights staged once in shared memory;
//   * one thread per column then walks the tile's rows in list order with a
//     running sum that it writes when the node changes: a node's sum is
//     formed in the plan's order by one block — no float atomics, no
//     accumulator tile, bit-identical across runs — and nodes without
//     edges are zeroed by the block that owns them, so every output row is
//     written exactly once;
//   * kernel 6 also stores each rounded h row, [E, 64] in x's type, and a
//     second launch sums those rows per node in the order of the plan's
//     transpose (ascending edge row): the other endpoint's sum without a
//     second pass over x and the MLP, and without atomics. Its own-endpoint
//     output comes from the same code as kernel 5's, bit for bit.
// This first version runs on the FP32 pipes; mma.sync / wgmma tiles are
// later work (PERF.md).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int H = 64;             // message width
constexpr int THREADS = 256;
constexpr int TE = 32;            // edges per tile
constexpr int G = THREADS / H;    // edge groups per tile
constexpr int EPT = TE / G;       // edges per thread per tile

size_t smem_bytes(int c, int na) {
  size_t floats = (size_t)(2 * c + na) * H + H * H + 4 * H + (size_t)2 * TE * c +
                  (size_t)TE * na + (size_t)2 * TE * H;
  return floats * 4 + 3 * TE * 4;
}

template <typename T, bool TWO, bool BOTH>
__global__ void __launch_bounds__(THREADS) banded_kernel(
    const T* __restrict__ x, const int* __restrict__ own,
    const int* __restrict__ oth, const float* __restrict__ attr,
    const int* __restrict__ perm, const int* __restrict__ nptr,
    const int* __restrict__ cnode, int wn, const T* __restrict__ w_own,
    const T* __restrict__ w_halo, const T* __restrict__ w_attr,
    const float* __restrict__ sc1, const T* __restrict__ w2,
    const float* __restrict__ sc2, float* __restrict__ out,
    T* __restrict__ hbuf, int n, int c, int na) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wo_s = reinterpret_cast<float*>(smem_raw);  // [c, H]
  float* wh_s = wo_s + c * H;                        // [c, H]
  float* wa_s = wh_s + c * H;                        // [na, H]
  float* w2_s = wa_s + na * H;                       // [H, H]
  float* sc_s = w2_s + H * H;                        // [4, H]: sc1, sc2
  float* xo_s = sc_s + 4 * H;                        // [TE, c]
  float* xt_s = xo_s + TE * c;                       // [TE, c]
  float* at_s = xt_s + TE * c;                       // [TE, na]
  float* h1_s = at_s + TE * na;                      // [TE, H]
  float* h_s = h1_s + TE * H;                        // [TE, H]
  int* row_s = reinterpret_cast<int*>(h_s + TE * H);  // [TE] edge row, -1 past the end
  int* node_s = row_s + TE;                           // [TE] own node
  int* othn_s = node_s + TE;                          // [TE] other node

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int n0 = cnode ? cnode[k] : k * wn;
  const int n1 = cnode ? cnode[k + 1] : min(n, (k + 1) * wn);
  const int e_begin = nptr[n0], e_end = nptr[n1];

  for (int i = tid; i < c * H; i += THREADS) {
    wo_s[i] = yk::to_f(w_own[i]);
    wh_s[i] = yk::to_f(w_halo[i]);
  }
  for (int i = tid; i < na * H; i += THREADS) wa_s[i] = yk::to_f(w_attr[i]);
  for (int i = tid; i < 2 * H; i += THREADS) sc_s[i] = sc1[i];
  if constexpr (TWO) {
    for (int i = tid; i < H * H; i += THREADS) w2_s[i] = yk::to_f(w2[i]);
    for (int i = tid; i < 2 * H; i += THREADS) sc_s[2 * H + i] = sc2[i];
  }
  // nodes of this range without an edge get their zero row here; the others
  // are written once by the column threads below
  for (int i = tid; i < (n1 - n0) * H; i += THREADS) {
    const int v = n0 + i / H;
    if (nptr[v + 1] == nptr[v]) out[(size_t)v * H + (i % H)] = 0.f;
  }

  const int g = tid / H, j = tid % H;
  int cur = -1;      // tid < H: the node whose sum `run` holds
  float run = 0.f;
  for (int e0 = e_begin; e0 < e_end; e0 += TE) {
    // also the barrier between the previous tile's sum and this tile's
    // shared-memory writes
    __syncthreads();
    // rows are clamped into [0, n) for memory safety only: ops/plans.py
    // rejects endpoints outside it when it makes the plan
    if (tid < TE) {
      int r = -1, a = 0, b = 0;
      if (e0 + tid < e_end) {
        r = perm ? perm[e0 + tid] : e0 + tid;
        a = min(max(own[r], 0), n - 1);
        b = min(max(oth[r], 0), n - 1);
      }
      row_s[tid] = r;
      node_s[tid] = a;
      othn_s[tid] = b;
    }
    __syncthreads();
    for (int i = tid; i < TE * c; i += THREADS) {
      const int el = i / c, kk = i - el * c;
      float xo = 0.f, xt = 0.f;
      if (row_s[el] >= 0) {
        xo = yk::to_f(x[(size_t)node_s[el] * c + kk]);
        xt = yk::to_f(x[(size_t)othn_s[el] * c + kk]);
      }
      xo_s[i] = xo;
      xt_s[i] = xt;
    }
    for (int i = tid; i < TE * na; i += THREADS) {
      const int el = i / na, r = row_s[el];
      at_s[i] = r >= 0 ? yk::round_to<T>(attr[(size_t)r * na + (i - el * na)]) : 0.f;
    }
    __syncthreads();

    float acc_o[EPT], acc_t[EPT], acc_a[EPT];
#pragma unroll
    for (int r = 0; r < EPT; ++r) acc_o[r] = acc_t[r] = acc_a[r] = 0.f;
    for (int kk = 0; kk < c; ++kk) {
      const float wo = wo_s[kk * H + j], wh = wh_s[kk * H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r) {
        const int el = g + r * G;
        acc_o[r] = fmaf(xo_s[el * c + kk], wo, acc_o[r]);
        acc_t[r] = fmaf(xt_s[el * c + kk], wh, acc_t[r]);
      }
    }
    for (int a = 0; a < na; ++a) {
      const float wa = wa_s[a * H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r) acc_a[r] = fmaf(at_s[(g + r * G) * na + a], wa, acc_a[r]);
    }
    float h[EPT];
    {
      const float s0 = sc_s[j], s1 = sc_s[H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r) {
        const float pre = (yk::round_to<T>(acc_o[r]) + yk::round_to<T>(acc_t[r])) + acc_a[r];
        h[r] = yk::round_to<T>(fmaxf(fmaf(pre, s0, s1), 0.f));
      }
    }
    if constexpr (TWO) {
#pragma unroll
      for (int r = 0; r < EPT; ++r) h1_s[(g + r * G) * H + j] = h[r];
      __syncthreads();
      float acc[EPT];
#pragma unroll
      for (int r = 0; r < EPT; ++r) acc[r] = 0.f;
      for (int kk = 0; kk < H; ++kk) {
        const float w = w2_s[kk * H + j];
#pragma unroll
        for (int r = 0; r < EPT; ++r) acc[r] = fmaf(h1_s[(g + r * G) * H + kk], w, acc[r]);
      }
      const float s0 = sc_s[2 * H + j], s1 = sc_s[3 * H + j];
#pragma unroll
      for (int r = 0; r < EPT; ++r) h[r] = yk::round_to<T>(fmaxf(fmaf(acc[r], s0, s1), 0.f));
    }
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int el = g + r * G;
      h_s[el * H + j] = h[r];
      if constexpr (BOTH)
        if (e0 + el < e_end) hbuf[(size_t)(e0 + el) * H + j] = yk::from_f<T>(h[r]);
    }
    __syncthreads();

    // one thread per column adds the tile's rows in list order and writes a
    // node's sum when the next node begins
    if (tid < H) {
      const int cnt = min(TE, e_end - e0);
      for (int el = 0; el < cnt; ++el) {
        const int v = node_s[el];
        if (v != cur) {
          if (cur >= 0) out[(size_t)cur * H + tid] = run;
          cur = v;
          run = 0.f;
        }
        run += h_s[el * H + tid];
      }
    }
  }
  if (tid < H && cur >= 0) out[(size_t)cur * H + tid] = run;
}

// out[v] = sum of hbuf rows tperm[tptr[v] : tptr[v + 1]], in that order
template <typename T>
__global__ void __launch_bounds__(THREADS) sum_rows_by_perm_kernel(
    const T* __restrict__ hbuf, const int* __restrict__ tperm,
    const int* __restrict__ tptr, float* __restrict__ out, int n) {
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int v = (int)(idx / H), j = (int)(idx % H);
  if (v >= n) return;
  float acc = 0.f;
  for (int i = tptr[v]; i < tptr[v + 1]; ++i) acc += yk::to_f(hbuf[(size_t)tperm[i] * H + j]);
  out[idx] = acc;
}

struct Args {
  const void *x, *own, *oth, *attr, *perm, *nptr, *cnode, *w_own, *w_halo, *w_attr,
      *sc1, *w2, *sc2, *tperm, *tptr;
  void *out, *hbuf, *out_oth;
  int n, c, na, nc, wn;
};

template <typename T, bool TWO, bool BOTH>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.c, a.na);
  cudaError_t err = cudaFuncSetAttribute(
      banded_kernel<T, TWO, BOTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_kernel<T, TWO, BOTH><<<a.nc, THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const int*>(a.own),
      static_cast<const int*>(a.oth), static_cast<const float*>(a.attr),
      static_cast<const int*>(a.perm), static_cast<const int*>(a.nptr),
      static_cast<const int*>(a.cnode), a.wn, static_cast<const T*>(a.w_own),
      static_cast<const T*>(a.w_halo), static_cast<const T*>(a.w_attr),
      static_cast<const float*>(a.sc1), static_cast<const T*>(a.w2),
      static_cast<const float*>(a.sc2), static_cast<float*>(a.out),
      static_cast<T*>(a.hbuf), a.n, a.c, a.na);
  err = cudaGetLastError();
  if (err != cudaSuccess || !BOTH) return (int)err;
  const int blocks = (int)(((size_t)a.n * H + THREADS - 1) / THREADS);
  sum_rows_by_perm_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a.hbuf), static_cast<const int*>(a.tperm),
      static_cast<const int*>(a.tptr), static_cast<float*>(a.out_oth), a.n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.hbuf) return launch<T, false, true>(a, stream);
  if (a.w2) return launch<T, true, false>(a, stream);
  return launch<T, false, false>(a, stream);
}

}  // namespace

extern "C" {

// x [n, c] (f32, or bf16 when bf16 != 0); own/oth [E] i32 and attr [E, na]
// f32, the edge rows; perm [E] i32 or null (rows already sorted by own);
// nptr [n + 1] i32 offsets of the sorted list; cnode [nc + 1] i32 node cuts
// or null (then nc = ceil(n / wn) windows of wn nodes); w_own/w_halo [c, 64]
// and w_attr [na, 64] in x's type; sc1 [2, 64] f32; w2 [64, 64] in x's type
// and sc2 [2, 64] f32, or both null (single stage); out [n, 64] f32.
// Kernel 6: hbuf [E, 64] scratch in x's type, tperm [E] / tptr [n + 1] i32
// (the transpose by the other endpoint) and out_oth [n, 64] f32, with perm
// and w2 null; kernel 5: all four null. Returns the CUDA error code of the
// launch.
int yk_banded_message_sum(const void* x, const void* own, const void* oth,
                          const void* attr, const void* perm, const void* nptr,
                          const void* cnode, const void* w_own, const void* w_halo,
                          const void* w_attr, const void* sc1, const void* w2,
                          const void* sc2, void* out, void* hbuf, const void* tperm,
                          const void* tptr, void* out_oth, int n, int c, int na,
                          int nc, int wn, int bf16, void* stream) {
  const Args a{x, own, oth, attr, perm, nptr, cnode, w_own, w_halo, w_attr, sc1,
               w2, sc2, tperm, tptr, out, hbuf, out_oth, n, c, na, nc, wn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}

// dynamic shared memory the launch asks for (bytes)
long yk_banded_message_smem_bytes(int c, int na) { return (long)smem_bytes(c, na); }

}  // extern "C"
