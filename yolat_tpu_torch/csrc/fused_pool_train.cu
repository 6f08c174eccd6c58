// Backward of the fused training pool head (kernel 11), for sm_90a.
//
// Replaces: yolat_tpu/ops/fused_pool_train.py, `_bwd_kernel` (:198, called
// through pallas_call at :275). For x [N, CI] (the masked fusion input),
// node mask m [N], W [CI, H], sc [2, H] (the forward's folded BN scale and
// shift), and per 8-row pool block the stored pooled maximum pb [N/8, H]
// (x's type) and the cotangent gb [N/8, H] f32, it recomputes per row
//   z = x @ W, y = z * sc[0] + sc[1],
//   u = gb if (m > 0, y > 0, relu(y) rounded to x's type == pb) else 0,
//   s = u * sc[0] rounded to x's type,
// and emits
//   dw_u = x^T s [CI, H] f32,  dx_s = s @ W^T [N, CI] in x's type,
//   sums[0] = sum u [H] f32,    sums[1] = sum u * z [H] f32.
// The recompute of z goes through the forward's own routine (block_max.cu;
// common.cuh: yk::pool_z_tile_bf16 at bf16, yk::mlp_rows8x4 at f32) on the
// same 64-row tiles and 128-column slabs, then yk::folded_pre, so a
// winner's relu(y), rounded to the stored type, equals the stored maximum
// bit for bit: every pool block with a positive maximum has a winner.
//
// What bounds it on the H100: the function needs three products of the
// forward's size (z to find the winners, x^T s, s @ W^T: 57 GFLOP at the
// bench batch, N 72704, CI 128, H 1024; 0.0578 ms on the bf16 tensor
// cores) against ~20 MB of inputs at bf16, so the arithmetic bounds it.
// This design runs four (z in both passes). The [N, H] u, s and z never go
// to device memory. The TPU kernel carries dW and the u-sums across its
// sequential grid; CTAs here run in no order, and no float atomics are used
// (two runs give identical bits):
//   * pass A, one CTA per 64-row tile, looping over H in slabs of 128 (the
//     next slab's W, pooled maxima, cotangents and scale/shift in flight by
//     cp.async): z of the slab, then u and s per element;
//     dx_tile += s_slab @ W_slab^T, and while it runs the tile's column
//     sums of u and u*z, reduced in a fixed order (the two rows of a thread,
//     a reduce-scatter over the 8 lanes of a column, the four warps in
//     order), as partials [N/64, 2, H];
//   * pass B, a grid of (H slab x chunk of tiles): recomputes s for each
//     tile of its chunk (the next tile's x in flight) and accumulates
//     x^T s over the chunk into partials [K, CI, H];
//   * pass C sums the partials in a fixed order.
// bf16 (bwd_rows_tc_kernel, bwd_dw_tc_kernel), one warpgroup per CTA, every
// product on the tensor cores (wgmma m64n128k16, f32 accumulation): z by the
// shared routine; in pass A s stays in registers as the A operand of
// dx += s W^T (the z accumulator's fragment, rounded to bf16 pairs, is the
// A fragment: 16 columns of z per k16 step), B the W slab already in shared
// memory, read K-major;
// in pass B s goes to shared memory and dW += x^T s reads the x tile and s
// MN-major (the transpose bits), two 64-row halves of CI when CI > 64.
// Measured on the H100 at the bench batch (scripts/pool_head_decomp.py):
// pass A 0.41 ms, pass B 0.15, pass C 0.04; without either product pass A
// is 4-5% faster, without its next slab's copy (W slab and block
// references, 8 per tile) ~20% faster: the copies, barriers and the
// per-element winner epilogue bound it, not the tensor cores. Not yet:
// TMA, a swizzled layout, overlapping one slab's products with the next
// slab's epilogue, a persistent grid, one pass instead of two.
// f32 (bwd_rows_kernel, bwd_dw_kernel): the same passes on the CUDA cores in
// IEEE FMA (no TF32), each thread 8 rows x 4 columns as the forward.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;       // rows per tile (8 pool blocks)
constexpr int COLS = 128;      // H columns per slab
constexpr int WS = COLS + 4;   // shared row stride of a W slab (16-byte rows)
constexpr int THREADS = 256;   // 8 row blocks x 32 column groups of 4
constexpr int BLOCK = yk::POOL_BLOCK;
constexpr int CI_MAX = 128;    // dx / dW register tiles cover CI <= 128

size_t smem_rows(int ci) {
  return ((size_t)ROWS * ci + (size_t)ci * WS + ROWS * COLS + 2 * BLOCK * COLS + ROWS) * 4;
}
size_t smem_dw(int ci) {
  return ((size_t)ci * WS + (size_t)ROWS * ci + ROWS * COLS + ROWS) * 4;
}

// the row term u of one (row, column): the cotangent if the row is a
// winner of its segment's max with a positive pre-activation, else 0
template <typename T>
__device__ __forceinline__ float winner_u(float acc, float s0, float s1, float m,
                                          float pooled, float gp) {
  const float y = yk::folded_pre(acc, s0, s1);
  const bool win = m > 0.f && y > 0.f && yk::round_to<T>(fmaxf(y, 0.f)) == pooled;
  return win ? gp : 0.f;
}

// stage rows [row0, row0 + ROWS) of x (as f32) and of the mask
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, const float* __restrict__ mask,
                                           size_t row0, int ci, float* x_s, float* m_s) {
  for (int i = threadIdx.x; i < ROWS * ci; i += THREADS) x_s[i] = yk::to_f(x[row0 * ci + i]);
  if (threadIdx.x < ROWS) m_s[threadIdx.x] = mask[row0 + threadIdx.x];
}

// stage columns [col0, col0 + COLS) of W (as f32) at row stride WS
template <typename T>
__device__ __forceinline__ void stage_slab(const T* __restrict__ w, int col0, int ci, int h,
                                           float* w_s) {
  for (int i = threadIdx.x; i < ci * COLS; i += THREADS) {
    const int kk = i / COLS, cc = i - kk * COLS;
    w_s[kk * WS + cc] = yk::to_f(w[(size_t)kk * h + col0 + cc]);
  }
}

// s of the thread's 8 rows x 4 columns of one tile and slab into s_s; u and
// u*z column sums over the 8 rows into us / uzs
template <typename T>
__device__ __forceinline__ void tile_s(const float* x_s, const float* m_s, const float* w_s,
                                       const float* __restrict__ sc,
                                       const T* __restrict__ pooled_b,
                                       const float* __restrict__ gp_b, size_t blk0, int col0,
                                       int ci, int h, float* s_s, float (&us)[4],
                                       float (&uzs)[4]) {
  const int rb = threadIdx.x / 32, cg = threadIdx.x % 32;
  float acc[BLOCK][4];
  yk::mlp_rows8x4(x_s + rb * BLOCK * ci, ci, w_s + cg * 4, WS, acc);
  const size_t blk = blk0 + rb;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = col0 + cg * 4 + q;
    const float s0 = sc[col], s1 = sc[h + col];
    const float pv = yk::to_f(pooled_b[blk * h + col]);
    const float gv = gp_b[blk * h + col];
    us[q] = 0.f;
    uzs[q] = 0.f;
#pragma unroll
    for (int r = 0; r < BLOCK; ++r) {
      const float u = winner_u<T>(acc[r][q], s0, s1, m_s[rb * BLOCK + r], pv, gv);
      us[q] += u;
      uzs[q] += u * acc[r][q];
      s_s[(rb * BLOCK + r) * COLS + cg * 4 + q] = yk::round_to<T>(u * s0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ mask, const T* __restrict__ w,
    const float* __restrict__ sc, const T* __restrict__ pooled_b,
    const float* __restrict__ gp_b, T* __restrict__ dx, float* __restrict__ part_u,
    int ci, int h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);  // [ROWS, ci]
  float* w_s = x_s + ROWS * ci;                     // [ci, WS]
  float* s_s = w_s + ci * WS;                       // [ROWS, COLS]
  float* red = s_s + ROWS * COLS;                   // [2, BLOCK, COLS]
  float* m_s = red + 2 * BLOCK * COLS;              // [ROWS]

  const int tid = threadIdx.x, rb = tid / 32, cg = tid % 32;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const size_t blk0 = (size_t)blockIdx.x * (ROWS / BLOCK);
  stage_tile(x, mask, row0, ci, x_s, m_s);

  // dx rows rb*8 + r, input columns cg + 32*q
  float dacc[BLOCK][4];
#pragma unroll
  for (int r = 0; r < BLOCK; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) dacc[r][q] = 0.f;

  for (int col0 = 0; col0 < h; col0 += COLS) {
    __syncthreads();  // the previous slab's readers of w_s, s_s, red are done
    stage_slab(w, col0, ci, h, w_s);
    __syncthreads();
    float us[4], uzs[4];
    tile_s<T>(x_s, m_s, w_s, sc, pooled_b, gp_b, blk0, col0, ci, h, s_s, us, uzs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[rb * COLS + cg * 4 + q] = us[q];
      red[(BLOCK + rb) * COLS + cg * 4 + q] = uzs[q];
    }
    __syncthreads();
    {  // the tile's column sums, row blocks in order (THREADS == 2 * COLS)
      const int which = tid / COLS, c = tid % COLS;
      float t = 0.f;
#pragma unroll
      for (int b = 0; b < BLOCK; ++b) t += red[(which * BLOCK + b) * COLS + c];
      part_u[((size_t)blockIdx.x * 2 + which) * h + col0 + c] = t;
    }
    for (int c = 0; c < COLS; ++c) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = cg + 32 * q;
        wv[q] = k < ci ? w_s[k * WS + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BLOCK; ++r) {
        const float sv = s_s[(rb * BLOCK + r) * COLS + c];
#pragma unroll
        for (int q = 0; q < 4; ++q) dacc[r][q] = fmaf(sv, wv[q], dacc[r][q]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BLOCK; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = cg + 32 * q;
      if (k < ci) dx[(row0 + rb * BLOCK + r) * ci + k] = yk::from_f<T>(dacc[r][q]);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_dw_kernel(
    const T* __restrict__ x, const float* __restrict__ mask, const T* __restrict__ w,
    const float* __restrict__ sc, const T* __restrict__ pooled_b,
    const float* __restrict__ gp_b, float* __restrict__ part_w, int ci, int h, int tiles,
    int tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [ci, WS]
  float* x_s = w_s + ci * WS;                       // [ROWS, ci]
  float* s_s = x_s + ROWS * ci;                     // [ROWS, COLS]
  float* m_s = s_s + ROWS * COLS;                   // [ROWS]

  const int tid = threadIdx.x, rb = tid / 32, cg = tid % 32;
  const int col0 = blockIdx.x * COLS;
  const int kper = ci / BLOCK;  // dW rows per row group: rb * kper + i
  const int t0 = blockIdx.y * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, tiles);
  stage_slab(w, col0, ci, h, w_s);

  float wacc[CI_MAX / BLOCK][4];
#pragma unroll
  for (int i = 0; i < CI_MAX / BLOCK; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) wacc[i][q] = 0.f;

  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile's readers of x_s, s_s are done
    stage_tile(x, mask, (size_t)t * ROWS, ci, x_s, m_s);
    __syncthreads();
    float us[4], uzs[4];
    tile_s<T>(x_s, m_s, w_s, sc, pooled_b, gp_b, (size_t)t * (ROWS / BLOCK), col0, ci, h,
              s_s, us, uzs);
    __syncthreads();
    for (int r = 0; r < ROWS; ++r) {
      const float4 sv = *reinterpret_cast<const float4*>(s_s + r * COLS + cg * 4);
#pragma unroll
      for (int i = 0; i < CI_MAX / BLOCK; ++i) {
        if (i < kper) {
          const float xv = x_s[r * ci + rb * kper + i];
          wacc[i][0] = fmaf(xv, sv.x, wacc[i][0]);
          wacc[i][1] = fmaf(xv, sv.y, wacc[i][1]);
          wacc[i][2] = fmaf(xv, sv.z, wacc[i][2]);
          wacc[i][3] = fmaf(xv, sv.w, wacc[i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CI_MAX / BLOCK; ++i) {
    if (i < kper) {
      float4 v = make_float4(wacc[i][0], wacc[i][1], wacc[i][2], wacc[i][3]);
      *reinterpret_cast<float4*>(
          part_w + ((size_t)blockIdx.y * ci + rb * kper + i) * h + col0 + cg * 4) = v;
    }
  }
}

// ---- bf16 on the tensor cores ----
using bf16 = __nv_bfloat16;
constexpr int SLAB = COLS * COLS;  // elements of a W slab with CI padded to 128

// pass A: two W slabs [128, 128], the x tile [64, kp], two slabs' pooled
// maxima [8, 128] bf16, cotangents [8, 128] f32 and scale/shift [2, 128]
// f32, the mask [64], the column-sum exchange [2, 4, 128] f32
size_t smem_rows_tc(int kp) {
  return 2 * (size_t)SLAB * 2 + (size_t)ROWS * kp * 2 + 2 * BLOCK * COLS * 2 +
         2 * BLOCK * COLS * 4 + 2 * 2 * COLS * 4 + ROWS * 4 + 2 * 4 * COLS * 4;
}
// pass B: the W slab [kp, 128], two x tiles [64, 128], s [64, 128], two
// tiles' pooled maxima and cotangents, scale/shift, two masks
size_t smem_dw_tc(int kp) {
  return (size_t)kp * COLS * 2 + 2 * (size_t)ROWS * COLS * 2 + (size_t)ROWS * COLS * 2 +
         2 * BLOCK * COLS * 2 + 2 * BLOCK * COLS * 4 + 2 * COLS * 4 + 2 * ROWS * 4;
}

// the [8, 128] pooled maxima and cotangents of pool blocks blk0.. and
// columns col0.. (16-byte copies; the wrapper aligns the tensors)
__device__ __forceinline__ void load_block_refs(const bf16* __restrict__ pooled_b,
                                                const float* __restrict__ gp_b, size_t blk0,
                                                int col0, int h, bf16* pb_s, float* gp_s) {
  const int tid = threadIdx.x;  // 128 threads: 8 rows x 16 pieces of pb
  const int b = tid / 16, q = tid % 16;
  yk::cp_async16(pb_s + b * COLS + q * 8, pooled_b + (blk0 + b) * h + col0 + q * 8);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = tid + i * yk::WG_THREADS, bb = k / 32, qq = k % 32;
    yk::cp_async16(gp_s + bb * COLS + qq * 4, gp_b + (blk0 + bb) * h + col0 + qq * 4);
  }
}

// sc[:, col0:col0 + 128] -> sc_s [2, 128]
__device__ __forceinline__ void load_sc(const float* __restrict__ sc, int col0, int h,
                                        float* sc_s) {
  const int tid = threadIdx.x;
  if (tid < 64) {
    const int r = tid / 32, q = tid % 32;
    yk::cp_async16(sc_s + r * COLS + q * 4, sc + (size_t)r * h + col0 + q * 4);
  }
}

// u of the four accumulator elements of column group j: rows 16 warp + g
// and + 8 (blocks br and br + 1), columns c = 8j + 2 t4 and c + 1, in the
// fragment's order; s0 gets sc[0] of the two columns. Pairs of scale/shift,
// pooled maxima and cotangents come in 8- and 4-byte shared loads.
__device__ __forceinline__ void tc_u4(const float (&z)[64], int j, int c, int br, bool in0,
                                      bool in1, const float* sc_s, const bf16* pb_s,
                                      const float* gp_s, float (&u)[4], float (&s0)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(sc_s + c);
  const float2 b = *reinterpret_cast<const float2*>(sc_s + COLS + c);
  s0[0] = a.x;
  s0[1] = a.y;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float2 pv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(pb_s + (br + hi) * COLS + c));
    const float2 gv = *reinterpret_cast<const float2*>(gp_s + (br + hi) * COLS + c);
    const float m = (hi ? in1 : in0) ? 1.f : 0.f;
    u[2 * hi] = winner_u<bf16>(z[4 * j + 2 * hi], a.x, b.x, m, pv.x, gv.x);
    u[2 * hi + 1] = winner_u<bf16>(z[4 * j + 2 * hi + 1], a.y, b.y, m, pv.y, gv.y);
  }
}

__global__ void __launch_bounds__(yk::WG_THREADS) bwd_rows_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ mask, const bf16* __restrict__ w,
    const float* __restrict__ sc, const bf16* __restrict__ pooled_b,
    const float* __restrict__ gp_b, bf16* __restrict__ dx, float* __restrict__ part_u,
    int ci, int h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kp = (ci + 15) & ~15;
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);          // 2 x [128, COLS]
  bf16* x_s = w_s + 2 * SLAB;                             // [ROWS, kp]
  bf16* pb_s = x_s + ROWS * kp;                           // 2 x [BLOCK, COLS]
  float* gp_s = reinterpret_cast<float*>(pb_s + 2 * BLOCK * COLS);  // 2 x [BLOCK, COLS]
  float* sc_s = gp_s + 2 * BLOCK * COLS;                  // 2 x [2, COLS]
  float* m_s = sc_s + 2 * 2 * COLS;                       // [ROWS]
  float* red = m_s + ROWS;                                // [2, 4, COLS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const size_t blk0 = (size_t)blockIdx.x * (ROWS / BLOCK);
  const int slabs = h / COLS;
  yk::zero_smem(smem_raw, (2 * SLAB + ROWS * kp) * 2);  // CI padding of W and x
  __syncthreads();
  yk::load_tiled(x_s, x + row0 * ci, ci, ROWS, ci, kp, true);
  if (tid < ROWS) yk::cp_async4(m_s + tid, mask + row0 + tid);
  auto load_slab = [&](int sl, int buf) {
    const int col0 = sl * COLS;
    yk::load_tiled(w_s + buf * SLAB, w + col0, h, ci, COLS, COLS, true);
    load_block_refs(pooled_b, gp_b, blk0, col0, h, pb_s + buf * BLOCK * COLS,
                    gp_s + buf * BLOCK * COLS);
    load_sc(sc, col0, h, sc_s + buf * 2 * COLS);
    yk::cp_async_commit();
  };
  load_slab(0, 0);

  float dacc[64];  // dx rows 16 warp + g (+ 8), input columns 8j + 2 t4 (+ 1)
#pragma unroll
  for (int i = 0; i < 64; ++i) dacc[i] = 0.f;
  for (int sl = 0; sl < slabs; ++sl) {
    const int buf = sl & 1, col0 = sl * COLS;
    if (sl + 1 < slabs) {
      load_slab(sl + 1, buf ^ 1);
      yk::cp_async_wait<1>();
    } else {
      yk::cp_async_wait<0>();
    }
    yk::fence_async_smem();
    __syncthreads();
    const bf16* wb = w_s + buf * SLAB;
    const bf16* pb = pb_s + buf * BLOCK * COLS;
    const float* gp = gp_s + buf * BLOCK * COLS;
    const float* scb = sc_s + buf * 2 * COLS;
    const bool in0 = m_s[16 * warp + g] > 0.f, in1 = m_s[16 * warp + 8 + g] > 0.f;
    float z[64];
    yk::pool_z_tile_bf16(x_s, wb, kp, z);

    uint32_t a[8][4];  // s as the A fragments of dx += s W^T, k16 step j/2
    float cs[64];      // column sums of the warp's two rows: u at 2j + q, u*z at 32 + 2j + q
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float u[4], s0[2], sv[4];
      tc_u4(z, j, 8 * j + 2 * t4, 2 * warp, in0, in1, scb, pb, gp, u, s0);
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[e] = u[e] * s0[e & 1];
      __nv_bfloat162 p0 = __floats2bfloat162_rn(sv[0], sv[1]);
      __nv_bfloat162 p1 = __floats2bfloat162_rn(sv[2], sv[3]);
      a[j / 2][(j & 1) * 2] = *reinterpret_cast<uint32_t*>(&p0);
      a[j / 2][(j & 1) * 2 + 1] = *reinterpret_cast<uint32_t*>(&p1);
      cs[2 * j] = u[0] + u[2];
      cs[2 * j + 1] = u[1] + u[3];
      cs[32 + 2 * j] = u[0] * z[4 * j] + u[2] * z[4 * j + 2];
      cs[32 + 2 * j + 1] = u[1] * z[4 * j + 1] + u[3] * z[4 * j + 3];
    }
    // dx += s_slab @ W_slab^T: B = the slab read K-major (K = H columns,
    // N = input channels, rows of the slab padded to 128 with zeros); the
    // column sums reduce while the products run
    const uint32_t wa = yk::smem_u32(wb);
    yk::fence_acc(dacc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) yk::fence_reg(a[kk][i]);
    yk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      yk::wgmma_rs<0>(dacc, a[kk], yk::gmma_desc(wa + kk * 256, 128, 16 * COLS), 1);
    yk::wgmma_commit();

    // the column sums over the warp's 16 rows (lane g keeps slots 8g..8g+7),
    // then the tile's, the four warps in order
    yk::reduce_scatter8(cs, [](float p, float q) { return p + q; });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int slot = 8 * g + i, which = slot / 32, k = slot % 32;
      red[(which * 4 + warp) * COLS + 8 * (k / 2) + 2 * t4 + (k & 1)] = cs[i];
    }
    __syncthreads();
    {
      const float* ru = red + tid;
      const float tu = ((ru[0] + ru[COLS]) + ru[2 * COLS]) + ru[3 * COLS];
      const float tz = ((ru[4 * COLS] + ru[5 * COLS]) + ru[6 * COLS]) + ru[7 * COLS];
      part_u[((size_t)blockIdx.x * 2) * h + col0 + tid] = tu;
      part_u[((size_t)blockIdx.x * 2 + 1) * h + col0 + tid] = tz;
    }
    yk::wgmma_wait_all();
    yk::fence_acc(dacc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) yk::fence_reg(a[kk][i]);
    __syncthreads();  // this slab's buffers and red are free
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t4;
    if (c < ci) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const size_t row = row0 + 16 * warp + g + 8 * hi;
        *reinterpret_cast<__nv_bfloat162*>(dx + row * ci + c) =
            __floats2bfloat162_rn(dacc[4 * j + 2 * hi], dacc[4 * j + 2 * hi + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(yk::WG_THREADS) bwd_dw_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ mask, const bf16* __restrict__ w,
    const float* __restrict__ sc, const bf16* __restrict__ pooled_b,
    const float* __restrict__ gp_b, float* __restrict__ part_w, int ci, int h, int tiles,
    int tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kp = (ci + 15) & ~15;
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);  // [kp, COLS]
  bf16* x_s = w_s + kp * COLS;                    // 2 x [ROWS, kp] in 2 x [ROWS, 128]
  bf16* s_s = x_s + 2 * ROWS * COLS;              // [ROWS, COLS]
  bf16* pb_s = s_s + ROWS * COLS;                 // 2 x [BLOCK, COLS]
  float* gp_s = reinterpret_cast<float*>(pb_s + 2 * BLOCK * COLS);  // 2 x [BLOCK, COLS]
  float* sc_s = gp_s + 2 * BLOCK * COLS;          // [2, COLS]
  float* m_s = sc_s + 2 * COLS;                   // 2 x [ROWS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int col0 = blockIdx.x * COLS;
  const int t0 = blockIdx.y * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, tiles);
  const bool two = ci > 64;  // dW rows in two 64-row halves
  // the padding of W and of both x buffers (a second half reads past kp)
  yk::zero_smem(smem_raw, (kp * COLS + 2 * ROWS * COLS) * 2);
  __syncthreads();
  yk::load_tiled(w_s, w + col0, h, ci, COLS, COLS, true);
  load_sc(sc, col0, h, sc_s);
  auto load_tile = [&](int t, int buf) {
    yk::load_tiled(x_s + buf * ROWS * COLS, x + (size_t)t * ROWS * ci, ci, ROWS, ci, kp, true);
    if (tid < ROWS) yk::cp_async4(m_s + buf * ROWS + tid, mask + (size_t)t * ROWS + tid);
    load_block_refs(pooled_b, gp_b, (size_t)t * (ROWS / BLOCK), col0, h,
                    pb_s + buf * BLOCK * COLS, gp_s + buf * BLOCK * COLS);
    yk::cp_async_commit();
  };
  if (t0 < t1) load_tile(t0, 0);
  else yk::cp_async_commit();

  float dw0[64], dw1[64];  // dW rows 16 warp + g (+ 8) (+ 64), columns 8j + 2 t4 (+ 1)
#pragma unroll
  for (int i = 0; i < 64; ++i) dw0[i] = dw1[i] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) {
      load_tile(t + 1, buf ^ 1);
      yk::cp_async_wait<1>();
    } else {
      yk::cp_async_wait<0>();
    }
    yk::fence_async_smem();
    __syncthreads();
    const bf16* xt = x_s + buf * ROWS * COLS;
    const bf16* pb = pb_s + buf * BLOCK * COLS;
    const float* gp = gp_s + buf * BLOCK * COLS;
    const float* mt = m_s + buf * ROWS;
    const bool in0 = mt[16 * warp + g] > 0.f, in1 = mt[16 * warp + 8 + g] > 0.f;
    float z[64];
    yk::pool_z_tile_bf16(xt, w_s, kp, z);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      float u[4], s0[2];
      tc_u4(z, j, c, 2 * warp, in0, in1, sc_s, pb, gp, u, s0);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<__nv_bfloat162*>(s_s + yk::tiled_off(16 * warp + g + 8 * hi, c, COLS)) =
            __floats2bfloat162_rn(u[2 * hi] * s0[0], u[2 * hi + 1] * s0[1]);
    }
    yk::fence_async_smem();
    __syncthreads();
    // dW += x_tile^T @ s: A = the x tile read MN-major (M = input channel,
    // K = row), B = s read MN-major (K = row, N = H column)
    const uint32_t xa = yk::smem_u32(xt), sa = yk::smem_u32(s_s);
    yk::fence_acc(dw0);
    yk::fence_acc(dw1);
    yk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
      const uint64_t db = yk::gmma_desc(sa + kk * 16 * COLS * 2, 16 * COLS, 128);
      yk::wgmma_ss<1, 1>(dw0, yk::gmma_desc(xa + kk * 32 * kp, 16 * kp, 128), db, 1);
      if (two)
        yk::wgmma_ss<1, 1>(dw1, yk::gmma_desc(xa + kk * 32 * kp + 1024, 16 * kp, 128), db, 1);
    }
    yk::wgmma_commit();
    yk::wgmma_wait_all();
    yk::fence_acc(dw0);
    yk::fence_acc(dw1);
    __syncthreads();  // this tile's buffers and s_s are free
  }
  yk::cp_async_wait<0>();  // an empty chunk's W slab copy
  float* pw = part_w + (size_t)blockIdx.y * ci * h + col0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int k0 = 16 * warp + g + 8 * hi;
      if (k0 < ci)
        *reinterpret_cast<float2*>(pw + (size_t)k0 * h + c) =
            make_float2(dw0[4 * j + 2 * hi], dw0[4 * j + 2 * hi + 1]);
      if (two && k0 + 64 < ci)
        *reinterpret_cast<float2*>(pw + (size_t)(k0 + 64) * h + c) =
            make_float2(dw1[4 * j + 2 * hi], dw1[4 * j + 2 * hi + 1]);
    }
  }
}

// out[j] = sum over p of part[p * len + j], p ascending
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int n_parts, size_t len) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float t = 0.f;
  for (int p = 0; p < n_parts; ++p) t += part[(size_t)p * len + j];
  out[j] = t;
}

int sum_parts(const float* part, float* out, int n_parts, size_t len, cudaStream_t st) {
  const int threads = 256;
  sum_parts_kernel<<<(unsigned)((len + threads - 1) / threads), threads, 0, st>>>(
      part, out, n_parts, len);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, const void* mask, const void* w, const void* sc,
              const void* pooled_b, const void* gp_b, void* dw_u, void* dx_s, void* sums,
              void* part_u, void* part_w, int n, int ci, int h, int kchunks, cudaStream_t st) {
  const int tiles = n / ROWS;
  const int per = (tiles + kchunks - 1) / kchunks;
  const int kp = (ci + 15) & ~15;
  const bf16* xt = static_cast<const bf16*>(x);
  const float* mf = static_cast<const float*>(mask);
  const bf16* wt = static_cast<const bf16*>(w);
  const float* scf = static_cast<const float*>(sc);
  const bf16* pb = static_cast<const bf16*>(pooled_b);
  const float* gb = static_cast<const float*>(gp_b);

  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_rows_tc(kp));
  if (err != cudaSuccess) return (int)err;
  bwd_rows_tc_kernel<<<tiles, yk::WG_THREADS, smem_rows_tc(kp), st>>>(
      xt, mf, wt, scf, pb, gb, static_cast<bf16*>(dx_s), static_cast<float*>(part_u), ci, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(bwd_dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dw_tc(kp));
  if (err != cudaSuccess) return (int)err;
  bwd_dw_tc_kernel<<<dim3(h / COLS, kchunks), yk::WG_THREADS, smem_dw_tc(kp), st>>>(
      xt, mf, wt, scf, pb, gb, static_cast<float*>(part_w), ci, h, tiles, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int rc = sum_parts(static_cast<const float*>(part_w), static_cast<float*>(dw_u), kchunks,
                     (size_t)ci * h, st);
  if (rc != 0) return rc;
  return sum_parts(static_cast<const float*>(part_u), static_cast<float*>(sums), tiles,
                   (size_t)2 * h, st);
}

template <typename T>
int launch(const void* x, const void* mask, const void* w, const void* sc,
           const void* pooled_b, const void* gp_b, void* dw_u, void* dx_s, void* sums,
           void* part_u, void* part_w, int n, int ci, int h, int kchunks,
           cudaStream_t st) {
  const int tiles = n / ROWS;
  const int per = (tiles + kchunks - 1) / kchunks;
  const T* xt = static_cast<const T*>(x);
  const float* mf = static_cast<const float*>(mask);
  const T* wt = static_cast<const T*>(w);
  const float* scf = static_cast<const float*>(sc);
  const T* pb = static_cast<const T*>(pooled_b);
  const float* gb = static_cast<const float*>(gp_b);

  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_rows(ci));
  if (err != cudaSuccess) return (int)err;
  bwd_rows_kernel<T><<<tiles, THREADS, smem_rows(ci), st>>>(
      xt, mf, wt, scf, pb, gb, static_cast<T*>(dx_s), static_cast<float*>(part_u), ci, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(bwd_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dw(ci));
  if (err != cudaSuccess) return (int)err;
  bwd_dw_kernel<T><<<dim3(h / COLS, kchunks), THREADS, smem_dw(ci), st>>>(
      xt, mf, wt, scf, pb, gb, static_cast<float*>(part_w), ci, h, tiles, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int rc = sum_parts(static_cast<const float*>(part_w), static_cast<float*>(dw_u), kchunks,
                     (size_t)ci * h, st);
  if (rc != 0) return rc;
  return sum_parts(static_cast<const float*>(part_u), static_cast<float*>(sums), tiles,
                   (size_t)2 * h, st);
}

}  // namespace

extern "C" {

// x [n, ci] (f32, or bf16 when bf16 != 0: the tensor-core kernels), mask
// [n] f32, w [ci, h] in x's type, sc [2, h] f32, pooled_b [n/8, h] in x's
// type, gp_b [n/8, h] f32 (at bf16 x, w, sc, pooled_b, gp_b 16-byte
// aligned) ->
// dw_u [ci, h] f32, dx_s [n, ci] in x's type, sums [2, h] f32 (sum u, sum
// u*z). Scratch: part_u [n/64, 2, h] f32, part_w [kchunks, ci, h] f32.
// Requires n % 64 == 0, h % 128 == 0, ci % 8 == 0, ci <= 128 and
// 1 <= kchunks <= n / 64. Returns the first nonzero CUDA error code of the
// four launches.
int yk_fused_pool_train_bwd(const void* x, const void* mask, const void* w, const void* sc,
                            const void* pooled_b, const void* gp_b, void* dw_u, void* dx_s,
                            void* sums, void* part_u, void* part_w, int n, int ci, int h,
                            int kchunks, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_tc(x, mask, w, sc, pooled_b, gp_b, dw_u, dx_s, sums, part_u, part_w, n, ci,
                     h, kchunks, st);
  return launch<float>(x, mask, w, sc, pooled_b, gp_b, dw_u, dx_s, sums, part_u, part_w, n,
                       ci, h, kchunks, st);
}

// the most shared memory any of the four passes A and B needs
long yk_fused_pool_train_smem_bytes(int ci) {
  const int kp = (ci + 15) & ~15;
  const size_t a = smem_rows(ci) > smem_dw(ci) ? smem_rows(ci) : smem_dw(ci);
  const size_t b = smem_rows_tc(kp) > smem_dw_tc(kp) ? smem_rows_tc(kp) : smem_dw_tc(kp);
  return (long)(a > b ? a : b);
}

}  // extern "C"
