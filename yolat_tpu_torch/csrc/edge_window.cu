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
// What bounds it on the H100: bytes. The per-edge MLP is 2*(2C+4)*64 +
// 2*64*64 flops (25 kFLOP at C = 64, 1.2 us for a bench batch's 46102
// edges on the bf16 tensor cores) against the [N, 64] f32 output (18.6 MB)
// and x read once. The TPU kernel turned the gathers into one-hot MXU
// contractions over a 3-window band of x padded to a fixed edge capacity
// per window, because a TPU has no fast row gather; Hopper gathers rows
// directly, so neither design keeps the one-hot matrices, the band or the
// capacity. One CTA per window of WN destination nodes; the window's edges
// stream through in tiles, and a node's sum is formed in the plan's order
// (no float atomics, bit-identical across runs); every output row of the
// window is written once.
//
// bf16, on the tensor cores (edge_window_tc_kernel; one warpgroup per CTA,
// ~73 KB of shared memory at C = 64 whatever WN: three CTAs per SM, a
// bench batch's 284 windows in one wave):
//   * W1 (pre-split, K = 2C+4 zero-padded to kp, a multiple of 16) and W2
//     staged once per CTA as bf16 in the tiled layout of common.cuh;
//   * tiles of 64 edges: the A operand [x[dst] | x[src] | round(attr)]
//     [64, kp] gathered with 16-byte cp.async (C % 8 == 0) into one of two
//     buffers, the next tile's rows behind this tile's products, from
//     indices and attributes loaded a tile earlier; at C % 8 != 0 (the
//     first conv, C = 5) the next tile's x values go to registers and are
//     stored after this tile's products;
//   * the first stage by one yk::msg_tile_bf16 (wgmma m64n64k16), fold,
//     ReLU, round; the second from registers by yk::msg_stage2_bf16, fold,
//     ReLU, round; h1 never goes through shared memory. No tie repair
//     (yk::msg_fix_ties): the limit of this kernel is 5e-3 of max|ref|;
//   * the per-node sum by yk::msg_run_sum over the tile's rows in list
//     order, all 128 threads, a node whose edges span tiles continued from
//     the tile before's carry; the four lanes of a 16-byte piece of a row
//     hand their sums to one, which stores it: one 16-byte store per piece
//     and row. A node of the window without an in-edge gets its zero row
//     first (the window's edges mark the others in a bit set).
//
// f32 (edge_window_kernel, for f32 x only, where each rounding above is
// the identity; IEEE FMA on the CUDA cores, no TF32): one CTA
// (8 warps) per window holds W1, W2 and the scale/shift pairs as f32 in
// shared memory; tiles of 32 edges, each thread computing 8 edges x 1
// column of each stage; a [WN, 64] f32 accumulator takes each tile's h2
// rows, one thread per column adding them in edge order.
//
// Decomposition variants (yk_edge_window_decomp). Replaces:
// scripts/ew_kernel_decomp.py, the probe kernel `main.make.kern` (:41-86,
// pallas_call at :105), which times kernel 1 at C = H = 64 with parts of
// its work switched off. The variant is a template parameter of both
// kernels above (the bf16 launch takes the tensor-core kernel), so
// everything but the tile's row loads is kernel 1's code:
//   full      kernel 1 itself (yk_edge_window_message_sum launches this
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

template <int V>
__global__ void __launch_bounds__(THREADS) edge_window_kernel(
    const float* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ dst, const float* __restrict__ attr,
    const int* __restrict__ wptr, const float* __restrict__ w1s,
    const float* __restrict__ sc1, const float* __restrict__ w2,
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

  for (int i = tid; i < (2 * c + na) * H; i += THREADS) w1_s[i] = w1s[i];
  for (int i = tid; i < H * H; i += THREADS) w2_s[i] = w2[i];
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
          xi = xj = 0.001f;
        } else {
          xi = x[(size_t)min(max(dst[e], 0), n - 1) * c + kk];
          if constexpr (V == kNoBand)
            xj = xi;
          else
            xj = x[(size_t)min(max(src[e], 0), n - 1) * c + kk];
        }
      }
      xi_s[i] = xi;
      xj_s[i] = xj;
    }
    for (int i = tid; i < TE * na; i += THREADS)
      at_s[i] = e0 + i / na < e_end ? attr[(size_t)e0 * na + i] : 0.f;
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
        h1_s[(g + r * G) * H + j] = fmaxf(acc[r] * s0 + s1, 0.f);
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
        h2_s[(g + r * G) * H + j] = fmaxf(acc[r] * s0 + s1, 0.f);
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

// ---- bf16 on the tensor cores ----
using bf16 = __nv_bfloat16;
constexpr int TM = 64;  // edges per tile
constexpr int XR = 8;   // x values per row half kept in registers (element loads)

__host__ __device__ inline int kp_of(int c, int na) { return (2 * c + na + 15) & ~15; }

// W1 [kp, 64], W2 [64, 64], two edge tiles [64, kp] and the h tile
// [64, MSG_HS] (bf16); sc1 and sc2 [4, 64] and two carries [64] (f32); two
// tiles' nodes [64] and meta [4], the window's has-an-in-edge bits (int)
size_t tc_smem_bytes(int kp, int wn) {
  return 2 * ((size_t)kp * H + H * H + 2 * (size_t)TM * kp + TM * yk::MSG_HS) +
         4 * (4 * H + 2 * H) + 4 * (2 * TM + 8 + (size_t)(wn + 31) / 32);
}

// What one thread loads a tile ahead for its row r = tid % 64. Half 0: the
// row's node d (-1 past the end) and, in lane 0, the node of the row before
// (-1 before the window's first edge or past its end). Half 1: the row s
// whose x fills the second half of A (src; dst for noband) and the row's
// first four attributes.
struct EdgeIdx {
  int d, dp, s;
  float at[4];
};

// x values of one row half, loaded at a tile's start and stored after its
// products (element loads only); row -1: nothing to store
struct XRow {
  uint32_t v[XR / 2];
  int row;
};

template <int V>
__global__ void __launch_bounds__(yk::WG_THREADS, 3) edge_window_tc_kernel(
    const bf16* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ dst, const float* __restrict__ attr,
    const int* __restrict__ wptr, const bf16* __restrict__ w1s,
    const float* __restrict__ sc1, const bf16* __restrict__ w2,
    const float* __restrict__ sc2, float* __restrict__ out, int n, int c,
    int wn, int na, int vec_x, int vec_w) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int kp = kp_of(c, na);
  bf16* w1_s = reinterpret_cast<bf16*>(smem_tc);  // [kp, H]: W1a - W1b; W1b; W1c
  bf16* w2_s = w1_s + kp * H;                      // [H, H]
  bf16* a_s = w2_s + H * H;                        // 2 x [TM, kp]: x[dst] | x[src] | attr
  bf16* h_s = a_s + 2 * TM * kp;                   // [TM, MSG_HS]
  float* sc_s = reinterpret_cast<float*>(h_s + TM * yk::MSG_HS);  // [4, H]: sc1, sc2
  float* carry_s = sc_s + 4 * H;                   // 2 x [H]
  int* node_s = reinterpret_cast<int*>(carry_s + 2 * H);  // 2 x [TM]
  int* meta_s = node_s + 2 * TM;                   // 2 x [4]: r1, cnt, continues
  unsigned* seen_s = reinterpret_cast<unsigned*>(meta_s + 8);  // [(wn + 31) / 32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = tid & (TM - 1), half = tid >> 6;
  const int k = blockIdx.x;
  const int node0 = k * wn, nodes = min(wn, n - node0);
  const int e_begin = wptr[k], e_end = wptr[k + 1];
  const int n_tiles = (e_end - e_begin + TM - 1) / TM;
  // the K padding of W1 and of the edge tiles stays zero
  yk::zero_smem(smem_tc, (kp * H + H * H + 2 * TM * kp) * 2);
  for (int i = tid; i < (wn + 31) / 32; i += yk::WG_THREADS) seen_s[i] = 0u;
  __syncthreads();
  yk::load_tiled(w1_s, w1s, H, 2 * c + na, H, H, vec_w);
  yk::load_tiled(w2_s, w2, H, H, H, H, vec_w);
  yk::cp_async_commit();
  for (int i = tid; i < 2 * H; i += yk::WG_THREADS) {
    sc_s[i] = sc1[i];
    sc_s[2 * H + i] = sc2[i];
  }
  // node rows are clamped into the window for memory safety only:
  // ops/plans.edge_window_plan rejects endpoints outside [0, n) and puts
  // each edge in its destination's window
  auto local = [&](int e) { return min(max(dst[e] - node0, 0), nodes - 1); };
  for (int e = e_begin + tid; e < e_end; e += yk::WG_THREADS) {
    const int v = local(e);
    atomicOr(seen_s + (v >> 5), 1u << (v & 31));
  }

  auto fetch = [&](int e0) {
    EdgeIdx ix;
    const int e = e0 + r;
    const bool ok = e < e_end;
    ix.d = ix.dp = -1;
    ix.s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) ix.at[q] = 0.f;
    if (half == 0) {
      if (ok) ix.d = node0 + local(e);
      if (lane == 0 && e > e_begin && e - 1 < e_end) ix.dp = node0 + local(e - 1);
    } else if (ok) {
      if constexpr (V == kFull) ix.s = min(max(src[e], 0), n - 1);
      if constexpr (V == kNoBand) ix.s = node0 + local(e);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < na) ix.at[q] = attr[(size_t)e * na + q];
    }
    return ix;
  };
  // edge tile t into buffer b: the x rows by cp.async (vec_x) or into xv
  // (element loads; `stage` stores them), the attributes rounded, each
  // row's node, the split row r1 (the first row >= 32 where a node begins,
  // or cnt), cnt, and whether the tile's first node continues from the
  // tile before
  auto issue = [&](int t, int b, const EdgeIdx& ix, XRow& xv) {
    const int e0 = e_begin + TM * t, cnt = min(TM, e_end - e0);
    const bool ok = r < cnt;
    bf16* a = a_s + b * TM * kp;
    if (half == 0) {
      const unsigned all = 0xffffffffu;
      int dp = __shfl_up_sync(all, ix.d, 1);
      if (lane == 0) dp = ix.dp;
      const unsigned begins = __ballot_sync(all, ok && ix.d != dp);
      node_s[b * TM + r] = ix.d;
      if (lane == 0 && warp == 1) meta_s[b * 4] = min(cnt, begins ? 32 + __ffs(begins) - 1 : TM);
      if (lane == 0 && warp == 0) {
        meta_s[b * 4 + 1] = cnt;
        meta_s[b * 4 + 2] = ix.dp >= 0 && ix.d == ix.dp;
      }
    } else if (ok) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < na) a[yk::tiled_off(r, 2 * c + q, kp)] = __float2bfloat16_rn(ix.at[q]);
      for (int q = 4; q < na; ++q)
        a[yk::tiled_off(r, 2 * c + q, kp)] =
            __float2bfloat16_rn(attr[(size_t)(e0 + r) * na + q]);
    }
    xv.row = -1;
    const int col0 = half * c;
    if (ok) {
      if constexpr (V == kNoOneHot) {
        if (c % 8 == 0) {
          const uint32_t u = yk::bf16_pair(0.001f, 0.001f);
          for (int q = 0; q < c / 8; ++q)
            *reinterpret_cast<uint4*>(a + yk::tiled_off(r, col0 + 8 * q, kp)) =
                make_uint4(u, u, u, u);
        } else {
          for (int q = 0; q < c; ++q)
            a[yk::tiled_off(r, col0 + q, kp)] = __float2bfloat16_rn(0.001f);
        }
      } else {
        const int row = half ? ix.s : ix.d;
        const bf16* xr = x + (size_t)row * c;
        if (vec_x) {
          for (int q = 0; q < c / 8; ++q)
            yk::cp_async16(a + yk::tiled_off(r, col0 + 8 * q, kp), xr + 8 * q);
        } else {
          const unsigned short* xu = reinterpret_cast<const unsigned short*>(xr);
#pragma unroll
          for (int q = 0; q < XR / 2; ++q) {
            const uint32_t lo = 2 * q < c ? xu[2 * q] : 0u;
            const uint32_t hi = 2 * q + 1 < c ? xu[2 * q + 1] : 0u;
            xv.v[q] = lo | (hi << 16);
          }
          xv.row = row;
        }
      }
    }
    yk::cp_async_commit();
  };
  // the element loads of `issue` into buffer b (values past XR: loaded
  // now); nothing for cp.async rows and the noonehot variant
  auto stage = [&](int b, const XRow& xv) {
    if (xv.row < 0) return;
    bf16* a = a_s + b * TM * kp;
    unsigned short* au = reinterpret_cast<unsigned short*>(a);
    const int col0 = half * c;
#pragma unroll
    for (int q = 0; q < XR; ++q)
      if (q < c)
        au[yk::tiled_off(r, col0 + q, kp)] = (unsigned short)(xv.v[q / 2] >> (16 * (q & 1)));
    for (int q = XR; q < c; ++q) a[yk::tiled_off(r, col0 + q, kp)] = x[(size_t)xv.row * c + q];
  };

  EdgeIdx ix;
  XRow xv;
  if (n_tiles > 0) ix = fetch(e_begin);
  __syncthreads();  // seen_s
  // nodes of the window without an in-edge get their zero row here; the
  // others are written once by the per-node sum
  for (int i = tid; i < nodes * (H / 4); i += yk::WG_THREADS) {
    const int v = i / (H / 4);
    if (!((seen_s[v >> 5] >> (v & 31)) & 1u))
      reinterpret_cast<float4*>(out + (size_t)(node0 + v) * H)[i % (H / 4)] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (n_tiles > 0) {
    issue(0, 0, ix, xv);
    stage(0, xv);
    if (n_tiles > 1) ix = fetch(e_begin + TM);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < n_tiles;
    yk::cp_async_wait<0>();
    yk::fence_async_smem();
    // tile t's rows (and at t = 0 the weights) are visible; the previous
    // tile's sum is done with h_s, the carries and the other buffers
    __syncthreads();
    if (more) {
      issue(t + 1, buf ^ 1, ix, xv);  // indices loaded a tile ago: no wait here
      if (t + 2 < n_tiles) ix = fetch(e_begin + TM * (t + 2));
    } else if (tid == 0) {
      meta_s[(buf ^ 1) * 4 + 2] = 0;  // the last tile's last node ends here
    }
    float acc[32], h[32];
    yk::msg_tile_bf16(a_s + buf * TM * kp, w1_s, kp, acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = yk::msg_col(i);
      h[i] = yk::round_to<bf16>(fmaxf(fmaf(acc[i], sc_s[col], sc_s[H + col]), 0.f));
    }
    yk::msg_stage2_bf16(h, w2_s, acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = yk::msg_col(i);
      h[i] = yk::round_to<bf16>(
          fmaxf(fmaf(acc[i], sc_s[2 * H + col], sc_s[3 * H + col]), 0.f));
    }
    yk::msg_store_rows(h, h_s);
    if (more) stage(buf ^ 1, xv);
    __syncthreads();
    // a node's sum continues from the carry of the tile before and, if its
    // edges go on into the next tile, ends in this tile's carry
    const int r1 = meta_s[buf * 4], cnt = meta_s[buf * 4 + 1];
    const bool cont_in = meta_s[buf * 4 + 2], cont_out = meta_s[(buf ^ 1) * 4 + 2];
    yk::msg_run_sum(
        h_s, node_s + buf * TM, r1, cnt,
        [&](int rr, int, int j) {
          return rr == 0 && cont_in ? carry_s[(buf ^ 1) * H + j] : 0.f;
        },
        [&](int rr, int v, int j, float sum) {
          // every lane of a warp walks the same rows, so the calls are
          // uniform over the warp: lane j % 4 == 0 gathers columns j..j+3
          const unsigned all = 0xffffffffu;
          const float s1 = __shfl_down_sync(all, sum, 1);
          const float s2 = __shfl_down_sync(all, sum, 2);
          const float s3 = __shfl_down_sync(all, sum, 3);
          if (rr == cnt && cont_out)
            carry_s[buf * H + j] = sum;
          else if ((j & 3) == 0)
            *reinterpret_cast<float4*>(out + (size_t)v * H + j) = make_float4(sum, s1, s2, s3);
        });
  }
  yk::cp_async_wait<0>();
}

// the dynamic shared memory a launch asks for, and the carveout that lets
// three tensor-core CTAs share an SM
template <typename K>
cudaError_t prepare(K* kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

size_t route_smem_bytes(int c, int na, int wn, int bf16) {
  return bf16 ? tc_smem_bytes(kp_of(c, na), wn) : smem_bytes(c, na, wn);
}

template <int V>
int launch(const void* x, const void* src, const void* dst, const void* attr,
           const void* wptr, const void* w1s, const void* sc1, const void* w2,
           const void* sc2, void* out, int n, int c, int nw, int wn, int na,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(c, na, wn);
  // the attribute belongs to each instantiation
  cudaError_t err = cudaFuncSetAttribute(
      edge_window_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_window_kernel<V><<<nw, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const float*>(attr),
      static_cast<const int*>(wptr), static_cast<const float*>(w1s),
      static_cast<const float*>(sc1), static_cast<const float*>(w2),
      static_cast<const float*>(sc2), static_cast<float*>(out), n, c, wn, na);
  return (int)cudaGetLastError();
}

template <int V>
int launch_tc(const void* x, const void* src, const void* dst, const void* attr,
              const void* wptr, const void* w1s, const void* sc1, const void* w2,
              const void* sc2, void* out, int n, int c, int nw, int wn, int na,
              cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(kp_of(c, na), wn);
  cudaError_t err = prepare(edge_window_tc_kernel<V>, smem);
  if (err != cudaSuccess) return (int)err;
  edge_window_tc_kernel<V><<<nw, yk::WG_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const float*>(attr),
      static_cast<const int*>(wptr), static_cast<const bf16*>(w1s),
      static_cast<const float*>(sc1), static_cast<const bf16*>(w2),
      static_cast<const float*>(sc2), static_cast<float*>(out), n, c, wn, na,
      c % 8 == 0 && yk::aligned16(x), yk::aligned16(w1s) && yk::aligned16(w2));
  return (int)cudaGetLastError();
}

template <int V>
int launch_typed(const void* x, const void* src, const void* dst,
                 const void* attr, const void* wptr, const void* w1s,
                 const void* sc1, const void* w2, const void* sc2, void* out,
                 int n, int c, int nw, int wn, int na, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_tc<V>(x, src, dst, attr, wptr, w1s, sc1, w2, sc2, out, n, c,
                        nw, wn, na, st);
  return launch<V>(x, src, dst, attr, wptr, w1s, sc1, w2, sc2, out, n,
                          c, nw, wn, na, st);
}

}  // namespace

extern "C" {

// x [n, c] (f32, or bf16 when bf16 != 0: the tensor-core kernel); src/dst [E] i32 (dst ascending);
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

// dynamic shared memory the launch of the f32 (bf16 == 0) or the bf16 route
// asks for (bytes)
long yk_edge_window_smem_bytes(int c, int na, int wn, int bf16) {
  return (long)route_smem_bytes(c, na, wn, bf16);
}

// CTAs of kernel 1's f32 or bf16 route that fit on one SM at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error
long yk_edge_window_ctas_per_sm(int c, int na, int wn, int bf16) {
  const size_t smem = route_smem_bytes(c, na, wn, bf16);
  int blocks = 0;
  cudaError_t err;
  if (bf16) {
    err = prepare(edge_window_tc_kernel<kFull>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, edge_window_tc_kernel<kFull>, yk::WG_THREADS, smem);
  } else {
    err = cudaFuncSetAttribute(edge_window_kernel<kFull>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, edge_window_kernel<kFull>, THREADS, smem);
  }
  return err == cudaSuccess ? (long)blocks : -(long)err;
}

const char* yk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
