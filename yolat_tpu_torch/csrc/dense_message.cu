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
// What bounds it on the H100: a used slot costs 2*(C+A)*64 + 2*64*64 flops
// against C values of x (L2 hits, mostly) and A attributes; the table is
// mostly padding (on the bench batch 46102 of 233472 slots are used, at
// most 3 per node), so the work to avoid is work on unused slots. The TPU
// kernel gathers x[nbr_idx] in XLA beforehand and expands s_i to the slot
// rows, and sums the slots back, by multiplying with a constant 0/1 matrix,
// because Mosaic cannot repeat or fold rows; here rows are gathered
// straight from global memory.
//
// bf16, on the tensor cores (dense_message_tc_kernel; one warpgroup per
// CTA, a persistent loop over tiles of 64 nodes, the weights staged once
// per CTA in the tiled layout of common.cuh):
//   * node stage: x_tile @ [W1a - W1b | Wr], one wgmma m64n128k16 product
//     over K = C padded to 16, the first pair tile's index loads and gather
//     issued while it runs; s_i rounded to bf16 into shared memory, the
//     skip kept in f32 registers until the output;
//   * compaction: the tile's used (node, slot) pairs, in (node, slot)
//     order, inside the kernel (no host-side nonzero, which would
//     synchronise): per-node counts from the tile's contiguous mask bytes
//     and their prefix; pair p finds its node by a binary search of the
//     prefix and its slot by walking the node's mask row. MLP rows are
//     computed for used slots only (the count: yk_dense_message_work);
//   * pair stage, per 64 used pairs: [x_nbr | round(attr)] gathered into
//     the tiled layout with 16-byte cp.async (element loads when C % 8 !=
//     0), the next tile's gather in flight behind this one's products;
//     the first stage by yk::msg_tile_bf16 (K = C + A padded to 16) plus
//     s_i of the pair's node, fold, ReLU, round; the second stage from
//     registers by yk::msg_stage2_bf16, fold, ReLU, round;
//   * sum: yk::msg_run_sum, each node's slots added in slot order by one
//     thread per (node, column), all 128 threads busy, no float atomics,
//     bit-identical across runs; then agg / max(cnt, 1) + skip + br,
//     stored in 16-byte pieces. Any N (the last tile is masked), D and C.
//
// f32 (dense_message_kernel; IEEE FMA on the CUDA cores, no TF32): a
// thread that owns (node, column) keeps s_i, the slot sum and the count in
// registers; a CTA walks tiles of 32 nodes with the weights staged as f32,
// and per slot that any node of the tile uses gathers the rows and runs
// both MLP stages for all 32 nodes; the slot sum runs over k = 0..D-1 in
// order in a register.
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

// ---- bf16 on the tensor cores ----
using bf16 = __nv_bfloat16;
constexpr int TM = 64;  // nodes per tile, used pairs per pair tile

// MLP rows (used pairs) and 64-row pair tiles the bf16 kernel computed
// since the last reset
__device__ unsigned long long g_dense_work[2];

// weights [kc, 128] + [kp, 64] + [64, 64], the x tile [64, kc], two pair
// tiles [64, kp], s_i and h2 [64, MSG_HS] (bf16); sc1, sc2, br [5, 64] and
// the sums [64, MSG_AS] (f32); counts [64], prefix [68], two tiles' node
// indices [2, 64], two split rows [4] (int)
size_t tc_smem_bytes(int kc, int kp) {
  return 2 * ((size_t)kc * 128 + (size_t)kp * H + H * H + (size_t)TM * kc +
              2 * (size_t)TM * kp + 2 * TM * yk::MSG_HS) +
         4 * (5 * H + TM * yk::MSG_AS) + 4 * (64 + 68 + 2 * TM + 4);
}

__global__ void __launch_bounds__(yk::WG_THREADS) dense_message_tc_kernel(
    const bf16* __restrict__ x, const int* __restrict__ nbr_idx,
    const float* __restrict__ nbr_attr, const uint8_t* __restrict__ nbr_mask,
    const bf16* __restrict__ w1s, const float* __restrict__ sc1,
    const bf16* __restrict__ w2, const float* __restrict__ sc2,
    const bf16* __restrict__ wr, const float* __restrict__ br,
    float* __restrict__ out, int n, int c, int d, int na, int n_tiles, int vec_x,
    int vec_w) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int kc = (c + 15) & ~15, kp = (c + na + 15) & ~15;
  bf16* wn_s = reinterpret_cast<bf16*>(smem_tc);   // [kc, 128]: W1a - W1b | Wr
  bf16* w1_s = wn_s + kc * 128;                     // [kp, H]: W1b; W1c
  bf16* w2_s = w1_s + kp * H;                       // [H, H]
  bf16* x_s = w2_s + H * H;                         // [TM, kc]
  bf16* a_s = x_s + TM * kc;                        // 2 x [TM, kp]
  bf16* s_s = a_s + 2 * TM * kp;                    // [TM, MSG_HS]
  bf16* h_s = s_s + TM * yk::MSG_HS;                // [TM, MSG_HS]
  float* sc_s = reinterpret_cast<float*>(h_s + TM * yk::MSG_HS);  // [5, H]
  float* agg_s = sc_s + 5 * H;                      // [TM, MSG_AS]
  int* cnt_s = reinterpret_cast<int*>(agg_s + TM * yk::MSG_AS);  // [TM]
  int* off_s = cnt_s + TM;                          // [TM + 1]
  int* ln_s = off_s + 68;                           // 2 x [TM]
  int* r1_s = ln_s + 2 * TM;                        // [2]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the K padding of the weights and of the x and pair tiles stays zero
  yk::zero_smem(smem_tc, (kc * 128 + kp * H + H * H + TM * kc + 2 * TM * kp) * 2);
  __syncthreads();
  yk::load_tiled(wn_s, w1s, H, c, H, 128, vec_w);
  yk::load_tiled(wn_s + 8 * 64, wr, H, c, H, 128, vec_w);  // columns 64..127
  yk::load_tiled(w1_s, w1s + (size_t)c * H, H, c + na, H, H, vec_w);
  yk::load_tiled(w2_s, w2, H, H, H, H, vec_w);
  yk::cp_async_commit();
  for (int i = tid; i < 2 * H; i += yk::WG_THREADS) {
    sc_s[i] = sc1[i];
    sc_s[2 * H + i] = sc2[i];
  }
  for (int i = tid; i < H; i += yk::WG_THREADS) sc_s[4 * H + i] = br[i];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int node0 = tile * TM, nt = min(TM, n - node0);
    // also the barrier after the previous tile's last reads of shared memory
    __syncthreads();
    yk::load_tiled(x_s, x + (size_t)node0 * c, c, nt, c, kc, vec_x);
    yk::cp_async_commit();
    for (int i = tid; i < TM * yk::MSG_AS / 4; i += yk::WG_THREADS)
      reinterpret_cast<float4*>(agg_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < TM) cnt_s[tid] = 0;
    __syncthreads();
    // per-node counts of used slots (integer adds: exact in any order) over
    // the tile's contiguous mask bytes, then their prefix
    const uint8_t* mt = nbr_mask + (size_t)node0 * d;
    for (int i = tid; i < nt * d; i += yk::WG_THREADS)
      if (mt[i]) atomicAdd(cnt_s + i / d, 1);
    __syncthreads();
    if (warp == 0) {
      const int c0 = cnt_s[2 * lane], c1 = cnt_s[2 * lane + 1];
      int inc = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      off_s[2 * lane] = inc - c0 - c1;
      off_s[2 * lane + 1] = inc - c1;
      if (lane == 31) off_s[TM] = inc;
    }
    yk::cp_async_wait<0>();
    yk::fence_async_smem();
    __syncthreads();

    const int n_pairs = off_s[TM], n_ptiles = (n_pairs + TM - 1) / TM;
    if (tid == 0 && n_pairs > 0) {
      atomicAdd(&g_dense_work[0], (unsigned long long)n_pairs);
      atomicAdd(&g_dense_work[1], (unsigned long long)n_ptiles);
    }

    // the largest local node whose pairs begin at or before pair p
    auto node_of = [&](int p) {
      int lo = 0, hi = TM - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off_s[mid] <= p) lo = mid; else hi = mid - 1;
      }
      return lo;
    };
    // pair tile t into buffer buf: row r = pair 64 t + r; threads r and
    // r + 64 split the row's 16-byte pieces, the second also writes the
    // attributes, the first the node index and the split row
    auto load_pairs = [&](int t, int buf) {
      const int r = tid & (TM - 1), half = tid >> 6;
      const int p = TM * t + r;
      const bool valid = p < n_pairs;
      int l = 0, idx = 0;
      size_t at = 0;
      if (valid) {
        l = node_of(p);
        const uint8_t* mrow = mt + (size_t)l * d;
        int k = p - off_s[l], s = 0;
        for (; s < d - 1; ++s)
          if (mrow[s] && k-- == 0) break;
        at = (size_t)(node0 + l) * d + s;
        // clamped for memory safety only: the table's rows lie in [0, n)
        idx = min(max(nbr_idx[at], 0), n - 1);
      }
      bf16* dst = a_s + buf * TM * kp;
      if (valid) {
        const bf16* src = x + (size_t)idx * c;
        if (vec_x) {
          for (int q = half; q < c / 8; q += 2)
            yk::cp_async16(dst + yk::tiled_off(r, q * 8, kp), src + q * 8);
        } else {
          for (int q = half; q < c; q += 2) dst[yk::tiled_off(r, q, kp)] = src[q];
        }
      }
      if (half) {
        for (int a = 0; a < na; ++a)
          dst[yk::tiled_off(r, c + a, kp)] =
              __float2bfloat16_rn(valid ? nbr_attr[at * na + a] : 0.f);
      } else {
        ln_s[buf * TM + r] = l;
        if (warp == 1) {  // the first row >= 32 where a node begins (or the end)
          int lp = __shfl_up_sync(0xffffffffu, l, 1);
          if (lane == 0) lp = node_of(p - 1);
          const unsigned b = __ballot_sync(0xffffffffu, !valid || l != lp);
          if (lane == 0) r1_s[buf] = min(min(TM, n_pairs - TM * t), b ? 32 + __ffs(b) - 1 : TM);
        }
      }
      yk::cp_async_commit();
    };

    // node stage: x_tile @ [W1a - W1b | Wr] (the product of
    // yk::pool_z_tile_bf16, issued here and waited for below), with the
    // first pair tile's index loads and gather running behind it; s_i
    // (rounded) to shared memory, the skip in registers
    float skip[32];
    {
      const uint32_t xa = yk::smem_u32(x_s), wa = yk::smem_u32(wn_s);
      float z[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) z[i] = 0.f;
      yk::fence_acc(z);
      yk::wgmma_fence();
      for (int k = 0; k < kc / 16; ++k)
        yk::wgmma_ss<0, 1>(z, yk::gmma_desc(xa + k * 256, 128, kc * 16),
                           yk::gmma_desc(wa + k * 16 * 128 * 2, 16 * 128, 128), k > 0);
      yk::wgmma_commit();
      if (n_ptiles > 0) load_pairs(0, 0);
      yk::wgmma_wait_all();
      yk::fence_acc(z);
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<uint32_t*>(s_s + yk::msg_row(i) * yk::MSG_HS + yk::msg_col(i)) =
            yk::bf16_pair(z[i], z[i + 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) skip[i] = z[32 + i];
    }
    for (int t = 0; t < n_ptiles; ++t) {
      const int buf = t & 1;
      yk::cp_async_wait<0>();
      yk::fence_async_smem();
      // tile t's pairs (and at t = 0 s_i) are visible; the previous tile's
      // sum is done with h_s and the other buffer
      __syncthreads();
      if (t + 1 < n_ptiles) load_pairs(t + 1, buf ^ 1);
      const int* ln = ln_s + buf * TM;
      float h[32];
      {
        float acc[32];
        yk::msg_tile_bf16(a_s + buf * TM * kp, w1_s, kp, acc);
        const int l0 = ln[yk::msg_row(0)], l1 = ln[yk::msg_row(2)];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = yk::msg_col(i);
          const int l = (i >> 1) & 1 ? l1 : l0;
          const float pre = acc[i] + __bfloat162float(s_s[l * yk::MSG_HS + col]);
          h[i] = yk::round_to<bf16>(fmaxf(fmaf(pre, sc_s[col], sc_s[H + col]), 0.f));
        }
      }
      {
        float acc[32];
        yk::msg_stage2_bf16(h, w2_s, acc);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = yk::msg_col(i);
          h[i] = yk::round_to<bf16>(
              fmaxf(fmaf(acc[i], sc_s[2 * H + col], sc_s[3 * H + col]), 0.f));
        }
      }
      yk::msg_store_rows(h, h_s);
      __syncthreads();
      yk::msg_run_sum(
          h_s, ln, r1_s[buf], min(TM, n_pairs - TM * t),
          [&](int, int l, int j) { return agg_s[l * yk::MSG_AS + j]; },
          [&](int, int l, int j, float v) { agg_s[l * yk::MSG_AS + j] = v; });
    }
    __syncthreads();
    // agg / max(cnt, 1) + skip + br in place, then 16-byte row stores
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = yk::msg_row(i), col = yk::msg_col(i);
      float* a = agg_s + row * yk::MSG_AS + col;
      *a = fmaf(*a, 1.f / fmaxf((float)cnt_s[row], 1.f), skip[i]) + sc_s[4 * H + col];
    }
    __syncthreads();
    for (int i = tid; i < nt * (H / 4); i += yk::WG_THREADS) {
      const int r = i / (H / 4), q = i % (H / 4);
      *reinterpret_cast<float4*>(out + (size_t)(node0 + r) * H + q * 4) =
          *reinterpret_cast<const float4*>(agg_s + r * yk::MSG_AS + q * 4);
    }
  }
  yk::cp_async_wait<0>();
}

int launch_tc(const void* x, const void* nbr_idx, const void* nbr_attr,
              const void* nbr_mask, const void* w1s, const void* sc1, const void* w2,
              const void* sc2, const void* wr, const void* br, void* out, int n, int c,
              int d, int na, int max_ctas, cudaStream_t stream) {
  const int kc = (c + 15) & ~15, kp = (c + na + 15) & ~15;
  const size_t smem = tc_smem_bytes(kc, kp);
  cudaError_t err = cudaFuncSetAttribute(
      dense_message_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + TM - 1) / TM;
  const int grid = n_tiles < max_ctas ? n_tiles : max_ctas;
  const bool vec_w = yk::aligned16(w1s) && yk::aligned16(w2) && yk::aligned16(wr);
  dense_message_tc_kernel<<<grid, yk::WG_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(nbr_idx),
      static_cast<const float*>(nbr_attr), static_cast<const uint8_t*>(nbr_mask),
      static_cast<const bf16*>(w1s), static_cast<const float*>(sc1),
      static_cast<const bf16*>(w2), static_cast<const float*>(sc2),
      static_cast<const bf16*>(wr), static_cast<const float*>(br),
      static_cast<float*>(out), n, c, d, na, n_tiles, c % 8 == 0 && yk::aligned16(x),
      vec_w);
  return (int)cudaGetLastError();
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
    return launch_tc(x, nbr_idx, nbr_attr, nbr_mask, w1s, sc1, w2, sc2, wr, br, out,
                     n, c, d, na, max_ctas, st);
  return launch<float>(x, nbr_idx, nbr_attr, nbr_mask, w1s, sc1, w2, sc2, wr,
                       br, out, n, c, d, na, max_ctas, st);
}

// dynamic shared memory the launch asks for (bytes): the larger of the f32
// and the bf16 kernel's
long yk_dense_message_smem_bytes(int c, int na) {
  const size_t a = smem_bytes(c, na), b = tc_smem_bytes((c + 15) & ~15, (c + na + 15) & ~15);
  return (long)(a > b ? a : b);
}

// The bf16 kernel's work since the last reset: out[0] MLP rows (used
// slots), out[1] 64-row pair tiles; reset != 0 then sets both to 0.
// Synchronises the device. Returns the CUDA error code.
int yk_dense_message_work(long long* out, int reset) {
  unsigned long long v[2];
  cudaError_t err = cudaMemcpyFromSymbol(v, g_dense_work, sizeof(v));
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)v[0];
  out[1] = (long long)v[1];
  if (reset) {
    const unsigned long long z[2] = {0, 0};
    err = cudaMemcpyToSymbol(g_dense_work, z, sizeof(z));
  }
  return (int)err;
}

}  // extern "C"
