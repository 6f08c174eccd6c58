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
// C = 64) against two gathered rows of x that mostly hit L2 — on the
// tensor cores not the arithmetic but the gathers, the barriers and the
// per-node sum. The TPU kernel is built around the lack of a row gather:
// ragged 512-row edge blocks assigned to 512-node windows, a 3-part x band
// with 128-row halos, one-hot MXU contractions against pre-projected band
// rows, spill tiles for the other endpoint's sums. Hopper gathers rows, so
// none of that is carried over. A thread block takes a range of nodes and
// their edges, contiguous in the sorted list. The ranges come from the
// plan: windows of wn nodes for the near-uniform conv edge family, or cuts
// of about equal edges + nodes that never split a node for the skewed
// clique family (dense cliques next to empty stretches).
//
// bf16, on the tensor cores (banded_tc_kernel; one warpgroup per block,
// about 72 KB of shared memory at C = 64: three blocks per SM):
//   * the range's edges stream through in tiles of 64, the next tile's
//     rows gathered with 16-byte cp.async into the tiled layout (element
//     loads when C % 8 != 0) behind this tile's products, from indices
//     loaded a tile earlier, so no index load stalls a tile;
//   * p_own = round(x[own] @ W_own) is a function of the node alone, so it
//     is formed once per node of a tile: the tile's distinct own nodes (a
//     warp ballot over the sorted rows gives each its slot) are gathered
//     into one 64-row tile and multiplied once; the tile's edges read
//     their node's row. A node whose edges span tiles is formed once in
//     each (the same value: a row of a wgmma product depends on that row
//     alone). Tiles of 64 contiguous nodes instead would leave a partial
//     edge tile and an exposed load at every node tile;
//   * p_oth by yk::msg_tile_bf16 (K = C padded to 16), issued right after
//     p_own's product; both pass yk::msg_fix_ties, so that each rounds to
//     bf16 as the f32 FMA chain of the plain version does; the epilogue
//     adds the attribute part (A f32 FMAs per element), folds, ReLU,
//     rounds; TWO: the second stage from registers (yk::msg_stage2_bf16),
//     repaired the same way;
//   * the per-node sum is yk::msg_run_sum: each node's edges are added in
//     list order by one thread per (node, column), the tile's rows split
//     between two halves of the threads at a node boundary, a node that
//     spans tiles continued from the tile before's carry: the order of a
//     sequential loop (that of the f32 kernel and of the other endpoint's
//     sum below), no float atomics, bit-identical across runs; a node's
//     row is stored once, when its last edge is added, and nodes without
//     edges get their zero row first;
//   * kernel 6 (BOTH) also stores each rounded h row, [E, 64] in x's type,
//     in 16-byte pieces, and a second launch sums those rows per node in
//     the order of the plan's transpose (ascending edge row): the other
//     endpoint's sum without a second pass over x and the MLP, and without
//     atomics. Its own-endpoint output comes from the same code as kernel
//     5's, bit for bit.
//
// f32 (banded_kernel; IEEE FMA on the CUDA cores, no TF32): the range's
// edges stream through in tiles of 32, both endpoint rows gathered, each
// thread computing 8 edges x 1 column from weights staged once as f32;
// one thread per column then walks the tile's rows in list order with a
// running sum that it writes when the node changes (the same order).
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

// ---- bf16 on the tensor cores ----
using bf16 = __nv_bfloat16;
constexpr int TM = 64;  // edges per tile

// weights [kc, 64] x 2 (+ W2 [64, 64]), two tiles' own-node and other rows
// [64, kc] x 2 each, p_own and h [64, MSG_HS] (bf16); W_attr [na, 64], sc1
// and sc2 [4, 64], two tiles' attributes [64, na], two carries [64] (f32);
// two tiles' distinct-node indices and own nodes [64] and meta [4] (int)
size_t tc_smem_bytes(int kc, int na, bool two) {
  return 2 * ((2 * (size_t)kc + (two ? H : 0)) * H + 4 * (size_t)TM * kc +
              2 * TM * yk::MSG_HS) +
         4 * ((size_t)na * H + 4 * H + 2 * (size_t)TM * na + 2 * H) + 4 * 2 * (2 * TM + 4);
}

// what one thread loads ahead for an edge tile: the own node of rows lane
// and 32 + lane, of the row before the tile, and the other node and the
// edge row of its row tid % 64 (-1 past the end)
struct EdgeIdx {
  int a_lo, a_hi, a_prev, b, row;
};

template <bool TWO, bool BOTH>
__global__ void __launch_bounds__(yk::WG_THREADS) banded_tc_kernel(
    const bf16* __restrict__ x, const int* __restrict__ own,
    const int* __restrict__ oth, const float* __restrict__ attr,
    const int* __restrict__ perm, const int* __restrict__ nptr,
    const int* __restrict__ cnode, int wn, const bf16* __restrict__ w_own,
    const bf16* __restrict__ w_halo, const bf16* __restrict__ w_attr,
    const float* __restrict__ sc1, const bf16* __restrict__ w2,
    const float* __restrict__ sc2, float* __restrict__ out,
    bf16* __restrict__ hbuf, int n, int c, int na, int vec_x, int vec_w) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int kc = (c + 15) & ~15;
  bf16* wo_s = reinterpret_cast<bf16*>(smem_tc);   // [kc, H]
  bf16* wh_s = wo_s + kc * H;                       // [kc, H]
  bf16* w2_s = wh_s + kc * H;                       // [H, H] (TWO)
  bf16* ao_s = w2_s + (TWO ? H * H : 0);            // 2 x [TM, kc]: own rows
  bf16* ax_s = ao_s + 2 * TM * kc;                  // 2 x [TM, kc]: other rows
  bf16* p_s = ax_s + 2 * TM * kc;                   // [TM, MSG_HS]
  bf16* h_s = p_s + TM * yk::MSG_HS;                // [TM, MSG_HS]
  float* wa_s = reinterpret_cast<float*>(h_s + TM * yk::MSG_HS);  // [na, H]
  float* sc_s = wa_s + na * H;                      // [4, H]: sc1, sc2
  float* at_s = sc_s + 4 * H;                       // 2 x [TM, na]
  float* carry_s = at_s + 2 * TM * na;              // 2 x [H]
  int* ln_s = reinterpret_cast<int*>(carry_s + 2 * H);  // 2 x [TM]
  int* node_s = ln_s + 2 * TM;                      // 2 x [TM]
  int* meta_s = node_s + 2 * TM;                    // 2 x [4]: r1, cnt, continues

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = tid & (TM - 1), half = tid >> 6;
  const bool hi = warp & 1;  // row r = 32 + lane
  const int k = blockIdx.x;
  const int n0 = cnode ? cnode[k] : k * wn;
  const int n1 = cnode ? cnode[k + 1] : min(n, (k + 1) * wn);
  const int e_begin = nptr[n0], e_end = nptr[n1];
  const int n_tiles = (e_end - e_begin + TM - 1) / TM;
  // the K padding of the weights and of the row tiles stays zero
  yk::zero_smem(smem_tc, ((2 * kc + (TWO ? H : 0)) * H + 4 * TM * kc) * 2);
  __syncthreads();
  yk::load_tiled(wo_s, w_own, H, c, H, H, vec_w);
  yk::load_tiled(wh_s, w_halo, H, c, H, H, vec_w);
  if constexpr (TWO) yk::load_tiled(w2_s, w2, H, H, H, H, vec_w);
  yk::cp_async_commit();
  for (int i = tid; i < na * H; i += yk::WG_THREADS) wa_s[i] = yk::to_f(w_attr[i]);
  for (int i = tid; i < 2 * H; i += yk::WG_THREADS) {
    sc_s[i] = sc1[i];
    if constexpr (TWO) sc_s[2 * H + i] = sc2[i];
  }
  // nodes of this range without an edge get their zero row here; the others
  // are written once by the per-node sum
  for (int i = tid; i < (n1 - n0) * (H / 4); i += yk::WG_THREADS) {
    const int v = n0 + i / (H / 4);
    if (nptr[v + 1] == nptr[v])
      reinterpret_cast<float4*>(out + (size_t)v * H)[i % (H / 4)] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // rows are clamped into [0, n) for memory safety only: ops/plans.py
  // rejects endpoints outside it when it makes the plan
  auto row_of = [&](int e) { return e < e_end ? (perm ? perm[e] : e) : -1; };
  auto own_of = [&](int rw) { return rw >= 0 ? min(max(own[rw], 0), n - 1) : -1; };
  auto fetch = [&](int e0) {
    EdgeIdx ix;
    ix.a_lo = own_of(row_of(e0 + lane));
    ix.a_hi = own_of(row_of(e0 + 32 + lane));
    ix.a_prev = e0 > e_begin ? own_of(row_of(e0 - 1)) : -1;
    ix.row = row_of(e0 + r);
    ix.b = ix.row >= 0 ? min(max(oth[ix.row], 0), n - 1) : 0;
    return ix;
  };
  // edge tile t into buffer buf: the rows' distinct own nodes (in order,
  // slot ln) and other nodes gathered, the attributes copied, the node
  // indices and the split row written
  auto issue = [&](int t, int buf, const EdgeIdx& ix) {
    const int cnt = min(TM, e_end - e_begin - TM * t);
    const unsigned all = 0xffffffffu, le = all >> (31 - lane);
    int p_lo = __shfl_up_sync(all, ix.a_lo, 1);
    int p_hi = __shfl_up_sync(all, ix.a_hi, 1);
    const int last_lo = __shfl_sync(all, ix.a_lo, 31);
    if (lane == 0) {
      p_lo = -2;  // row 0 begins the tile's first node
      p_hi = last_lo;
    }
    const unsigned b0 = __ballot_sync(all, lane < cnt && ix.a_lo != p_lo);
    const unsigned b1 = __ballot_sync(all, 32 + lane < cnt && ix.a_hi != p_hi);
    const int a = hi ? ix.a_hi : ix.a_lo;
    const bool begins = ((hi ? b1 : b0) >> lane) & 1;
    const int ln = hi ? __popc(b0) + __popc(b1 & le) - 1 : __popc(b0 & le) - 1;
    bf16* ao = ao_s + buf * TM * kc;
    bf16* ax = ax_s + buf * TM * kc;
    const bf16* xo = x + (size_t)a * c;
    const bf16* xb = x + (size_t)ix.b * c;
    if (vec_x) {
      for (int q = half; q < c / 8; q += 2) {
        if (begins) yk::cp_async16(ao + yk::tiled_off(ln, q * 8, kc), xo + q * 8);
        if (r < cnt) yk::cp_async16(ax + yk::tiled_off(r, q * 8, kc), xb + q * 8);
      }
    } else {
      for (int q = half; q < c; q += 2) {
        if (begins) ao[yk::tiled_off(ln, q, kc)] = xo[q];
        if (r < cnt) ax[yk::tiled_off(r, q, kc)] = xb[q];
      }
    }
    if (half) {
      if (r < cnt)
        for (int q = 0; q < na; ++q)
          yk::cp_async4(at_s + (buf * TM + r) * na + q, attr + (size_t)ix.row * na + q);
    } else {
      ln_s[buf * TM + r] = max(ln, 0);
      node_s[buf * TM + r] = a;
      if (tid == 0) {
        meta_s[buf * 4] = min(cnt, b1 ? 32 + __ffs(b1) - 1 : TM);
        meta_s[buf * 4 + 1] = cnt;
        meta_s[buf * 4 + 2] = ix.a_prev >= 0 && ix.a_lo == ix.a_prev;
      }
    }
    yk::cp_async_commit();
  };

  EdgeIdx ix;
  if (n_tiles > 0) {
    ix = fetch(e_begin);
    issue(0, 0, ix);
    if (n_tiles > 1) ix = fetch(e_begin + TM);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, e0 = e_begin + TM * t;
    yk::cp_async_wait<0>();
    yk::fence_async_smem();
    // tile t's rows are visible; the previous tile is done with p_s, h_s
    // and the other buffers
    __syncthreads();
    if (t + 1 < n_tiles) {
      issue(t + 1, buf ^ 1, ix);  // indices loaded a tile ago: no wait here
      if (t + 2 < n_tiles) ix = fetch(e0 + 2 * TM);
    } else if (tid == 0) {
      meta_s[(buf ^ 1) * 4 + 2] = 0;  // the last tile's last node ends here
    }
    const int* ln = ln_s + buf * TM;
    const int* nd = node_s + buf * TM;
    const int r1 = meta_s[buf * 4], cnt = meta_s[buf * 4 + 1];
    const int n_own = ln[cnt - 1] + 1;  // distinct own nodes of the tile
    const bf16* ao = ao_s + buf * TM * kc;
    const bf16* ax = ax_s + buf * TM * kc;
    float acc[32], acc_o[32];
    // p_own of the tile's distinct nodes and p_oth, back to back
    yk::msg_tile_issue(ao, wo_s, kc, acc_o);
    yk::msg_tile_issue(ax, wh_s, kc, acc);
    yk::msg_tile_wait(acc_o);
    yk::fence_acc(acc);
    yk::msg_fix_ties(acc_o, [&](int rr, int g) {
      return *reinterpret_cast<const uint4*>(ao + yk::tiled_off(rr, 8 * g, kc));
    }, wo_s, c, n_own, [](int, float v) { return v; });
    yk::msg_store_rows(acc_o, p_s);  // rounded, by the node's slot
    float h[32];
    {  // the first stage's epilogue
      yk::msg_fix_ties(acc, [&](int rr, int g) {
        return *reinterpret_cast<const uint4*>(ax + yk::tiled_off(rr, 8 * g, kc));
      }, wh_s, c, cnt, [](int, float v) { return v; });
      __syncthreads();  // p_s
      const float* at = at_s + buf * TM * na;
      const int ra = yk::msg_row(0), rb = yk::msg_row(2);
      const int la = ln[ra], lb = ln[rb];
      // the attribute part, round(attr) @ W_attr, one FMA chain over the
      // attributes per element
      float pa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pa[i] = 0.f;
      for (int q = 0; q < na; ++q) {
        const float a0 = yk::round_to<bf16>(at[ra * na + q]);
        const float a1 = yk::round_to<bf16>(at[rb * na + q]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          pa[i] = fmaf((i >> 1) & 1 ? a1 : a0, wa_s[q * H + yk::msg_col(i)], pa[i]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = yk::msg_col(i);
        const float po =
            __bfloat162float(p_s[((i >> 1) & 1 ? lb : la) * yk::MSG_HS + col]);
        const float pre = (po + yk::round_to<bf16>(acc[i])) + pa[i];
        h[i] = yk::round_to<bf16>(fmaxf(fmaf(pre, sc_s[col], sc_s[H + col]), 0.f));
      }
    }
    if constexpr (TWO) {
      // h1 to the warp's own rows of h_s for the chain of near-midpoint
      // elements (the four lanes of a row are in one warp)
      yk::msg_store_rows(h, h_s);
      __syncwarp();
      yk::msg_stage2_bf16(h, w2_s, acc);
      auto fold2 = [&](int i, float v) {
        const int col = yk::msg_col(i);
        return fmaxf(fmaf(v, sc_s[2 * H + col], sc_s[3 * H + col]), 0.f);
      };
      yk::msg_fix_ties(acc, [&](int rr, int g) {
        return *reinterpret_cast<const uint4*>(h_s + rr * yk::MSG_HS + 8 * g);
      }, w2_s, H, cnt, fold2);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = yk::round_to<bf16>(fold2(i, acc[i]));
    }
    yk::msg_store_rows(h, h_s);
    __syncthreads();
    // a node's sum continues from the carry of the tile before and, if its
    // edges go on into the next tile, ends in this tile's carry
    const bool cont_in = meta_s[buf * 4 + 2], cont_out = meta_s[(buf ^ 1) * 4 + 2];
    yk::msg_run_sum(
        h_s, nd, r1, cnt,
        [&](int rr, int, int j) {
          return rr == 0 && cont_in ? carry_s[(buf ^ 1) * H + j] : 0.f;
        },
        [&](int rr, int v, int j, float sum) {
          if (rr == cnt && cont_out)
            carry_s[buf * H + j] = sum;
          else
            out[(size_t)v * H + j] = sum;
        });
    if constexpr (BOTH) {
      for (int i = tid; i < cnt * (H / 8); i += yk::WG_THREADS) {
        const int rr = i / (H / 8), q = i % (H / 8);
        *reinterpret_cast<uint4*>(hbuf + (size_t)(e0 + rr) * H + q * 8) =
            *reinterpret_cast<const uint4*>(h_s + rr * yk::MSG_HS + q * 8);
      }
    }
  }
  yk::cp_async_wait<0>();
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

// kernel 6's second launch: the other endpoint's sums of the stored h rows
template <typename T>
int launch_oth(const Args& a, cudaStream_t stream) {
  const int blocks = (int)(((size_t)a.n * H + THREADS - 1) / THREADS);
  sum_rows_by_perm_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a.hbuf), static_cast<const int*>(a.tperm),
      static_cast<const int*>(a.tptr), static_cast<float*>(a.out_oth), a.n);
  return (int)cudaGetLastError();
}

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
  return launch_oth<T>(a, stream);
}

template <bool TWO, bool BOTH>
int launch_tc(const Args& a, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes((a.c + 15) & ~15, a.na, TWO);
  cudaError_t err = cudaFuncSetAttribute(
      banded_tc_kernel<TWO, BOTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_w = yk::aligned16(a.w_own) && yk::aligned16(a.w_halo) &&
                     (!TWO || yk::aligned16(a.w2));
  banded_tc_kernel<TWO, BOTH><<<a.nc, yk::WG_THREADS, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const int*>(a.own),
      static_cast<const int*>(a.oth), static_cast<const float*>(a.attr),
      static_cast<const int*>(a.perm), static_cast<const int*>(a.nptr),
      static_cast<const int*>(a.cnode), a.wn, static_cast<const bf16*>(a.w_own),
      static_cast<const bf16*>(a.w_halo), static_cast<const bf16*>(a.w_attr),
      static_cast<const float*>(a.sc1), static_cast<const bf16*>(a.w2),
      static_cast<const float*>(a.sc2), static_cast<float*>(a.out),
      static_cast<bf16*>(a.hbuf), a.n, a.c, a.na, a.c % 8 == 0 && yk::aligned16(a.x),
      vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || !BOTH) return (int)err;
  return launch_oth<bf16>(a, stream);
}

int dispatch(const Args& a, bool tensor_cores, cudaStream_t stream) {
  if (tensor_cores) {
    if (a.hbuf) return launch_tc<false, true>(a, stream);
    if (a.w2) return launch_tc<true, false>(a, stream);
    return launch_tc<false, false>(a, stream);
  }
  if (a.hbuf) return launch<float, false, true>(a, stream);
  if (a.w2) return launch<float, true, false>(a, stream);
  return launch<float, false, false>(a, stream);
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
  return dispatch(a, bf16 != 0, st);
}

// dynamic shared memory the launch asks for (bytes): the larger of the f32
// and the bf16 kernel's
long yk_banded_message_smem_bytes(int c, int na) {
  const size_t a = smem_bytes(c, na), b = tc_smem_bytes((c + 15) & ~15, na, true);
  return (long)(a > b ? a : b);
}

}  // extern "C"
