// Shared helpers of the yolat_tpu_torch kernels: float <-> storage-type
// conversion (f32 or bf16), rounding to the storage type's precision, and
// the pool head's per-row arithmetic.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace yk {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, kept as float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// Pool head arithmetic, shared by the block-max kernels (block_max.cu) and
// the fused pool head's backward (fused_pool_train.cu). The backward finds
// the segment-max winners by comparing its recompute of relu(z * s0 + s1),
// z = x @ W, with the maximum the forward stored, so both must produce the
// same float bit for bit, and so every z of a route comes from one routine:
//   * f32 (IEEE FMA on the CUDA cores, no TF32): yk::mlp_rows8x4, one fmaf
//     chain per output over k = 0..ci-1 from 0;
//   * bf16 (tensor cores): yk::pool_z_tile_bf16, one warpgroup issuing
//     wgmma m64n128k16 over k16 steps in ascending order from a zero
//     accumulator, both operands read from shared memory in the layout of
//     yk::tiled_off. The tensor cores' f32 sums are not IEEE FMA chains
//     and need not round as another instruction shape (m64n256, mma.sync)
//     or another k order would, so no bf16 kernel computes a pool-head z
//     any other way: the same 64-row tile and 128-column slab, the same
//     shared layout, the same zero padding of K to a multiple of 16.
// Then fmaf(z, s0, s1) (yk::folded_pre) and the ReLU on either route.
constexpr int POOL_BLOCK = 8;  // pool block rows

// acc[r][q] = sum_k xr[r * ci + k] * wc[k * ws + q] for r < 8, q < 4. wc
// must be 16-byte aligned and ws a multiple of 4 (float4 loads).
__device__ __forceinline__ void mlp_rows8x4(const float* __restrict__ xr, int ci,
                                            const float* __restrict__ wc, int ws,
                                            float (&acc)[POOL_BLOCK][4]) {
#pragma unroll
  for (int r = 0; r < POOL_BLOCK; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int kk = 0; kk < ci; ++kk) {
    const float4 wv = *reinterpret_cast<const float4*>(wc + kk * ws);
#pragma unroll
    for (int r = 0; r < POOL_BLOCK; ++r) {
      const float xv = xr[r * ci + kk];
      acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
      acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
      acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
      acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
    }
  }
}

// the folded scale/shift before the ReLU: y = acc * s0 + s1, one rounding
__device__ __forceinline__ float folded_pre(float acc, float s0, float s1) {
  return fmaf(acc, s0, s1);
}

// ---- the bf16 route on Hopper's tensor cores (sm_90a) ----
//
// Shared layout of every wgmma operand: an R x C bf16 matrix whose C index
// is contiguous in device memory is kept as 8 x 8 core matrices of 128
// contiguous bytes (8 rows of 16 bytes), row groups outermost. wgmma reads
// it unswizzled (layout type 0) either way round: as a K-major operand
// (rows M or N, columns K: K-group stride 128 bytes, MN-group stride 16 C
// bytes) or as an MN-major one (rows K, columns M or N, the transpose bit
// set: MN-group stride 128 bytes, K-group stride 16 C bytes).
constexpr int Z_COLS = 128;   // H columns of a slab (tiles: 64 rows)
constexpr int WG_THREADS = 128;  // one warpgroup

// element offset of (r, c) in an R x C tiled matrix (C a multiple of 8)
__device__ __forceinline__ int tiled_off(int r, int c, int cols) {
  return (r >> 3) * cols * 8 + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor: start address, K-group (leading) and MN-group
// (stride) byte offsets, no swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t k_bytes,
                                              uint32_t mn_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(k_bytes >> 4) << 16) |
         ((uint64_t)(mn_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy shared-memory writes (st.shared, cp.async) made visible to
// wgmma's operand reads; each writer runs it before the barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins an operand register's definitions before the wgmma_fence that
// follows and its reads after the wait that completes the products; ptxas
// serialises the wgmma pipeline if a register of it is written between
// the fence and the commit (C7515)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define YK_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define YK_D64 \
  YK_D8(0), YK_D8(8), YK_D8(16), YK_D8(24), YK_D8(32), YK_D8(40), YK_D8(48), YK_D8(56)
#define YK_R64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 accumulate; A and B
// from shared memory; TA / TB: the operand is MN-major; accumulate: add to
// d (else d = A B). Accumulator element i of thread (warp w, lane l): row
// 16w + l/4 + 8((i/2)&1), column 8(i/4) + 2(l%4) + (i&1).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " YK_R64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : YK_D64
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// the same with A [64 x 16] from registers: a0 = (row l/4, k 2(l%4)..+1),
// a1 = row + 8, a2 = k + 8, a3 = both (bf16 pairs, low half first)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " YK_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : YK_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// The bf16 pool-head z tile: z = x_tile @ w_slab [64 x 128], f32. x_s is the
// tile [64, kp] and w_s the slab [>= kp, 128] (rows K = input channel), both
// tiled; kp = ci rounded up to 16 and the padding zero in both. The caller
// is one whole warpgroup (the CTA), after fence_async_smem and a barrier
// over the operands' writes. Kernels 2, 3 and 11 (both passes) compute every
// bf16 z through this routine; see the contract above.
__device__ __forceinline__ void pool_z_tile_bf16(const __nv_bfloat16* x_s,
                                                 const __nv_bfloat16* w_s, int kp,
                                                 float (&z)[64]) {
  const uint32_t xa = smem_u32(x_s), wa = smem_u32(w_s);
#pragma unroll
  for (int i = 0; i < 64; ++i) z[i] = 0.f;
  fence_acc(z);
  wgmma_fence();
  for (int k = 0; k < kp / 16; ++k)
    wgmma_ss<0, 1>(z, gmma_desc(xa + k * 256, 128, kp * 16),
                   gmma_desc(wa + k * 16 * Z_COLS * 2, 16 * Z_COLS, 128), k > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(z);
}

// Reduce-scatter over the 8 lanes that share lane % 4 (lane bits 2-4; in
// an accumulator fragment, the 8 rows of one column pair): v holds N slots
// per lane; afterwards v[0, N/8) of lane l holds slots (N/8) g .. (N/8) g +
// N/8 - 1, g = l / 4, each combined over the 8 lanes by op in a fixed tree
// (3 rounds, N - N/8 shuffles instead of 3 N for a butterfly per slot).
template <int N, typename T, typename Op>
__device__ __forceinline__ void reduce_scatter8(T (&v)[N], Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int o = 16 >> r, half = N >> (r + 1);
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const T send = up ? v[i] : v[i + half];
      const T keep = up ? v[i + half] : v[i];
      v[i] = op(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
  }
}

// a 16-byte global -> shared copy, completed by cp_async_wait
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, rows) x columns [0, cols) of a bf16 row-major matrix (row
// stride ld elements) into a tiled [*, tcols] shared matrix; the caller
// zeroes the padding once. vec: 16-byte cp.async (cols % 8 == 0, src and ld
// 16-byte aligned), each 8 lanes filling one 128-byte core matrix; else
// plain element loads.
__device__ __forceinline__ void load_tiled(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           size_t ld, int rows, int cols, int tcols,
                                           bool vec) {
  if (vec) {
    const int nc = cols / 8, total = ((rows + 7) & ~7) * nc;
    for (int i = threadIdx.x; i < total; i += WG_THREADS) {
      const int r8 = i & 7, rest = i >> 3;
      const int c = rest % nc, rg = rest / nc;
      const int r = rg * 8 + r8;
      if (r < rows) cp_async16(dst + tiled_off(r, c * 8, tcols), src + r * ld + c * 8);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += WG_THREADS) {
      const int r = i / cols, c = i - r * cols;
      dst[tiled_off(r, c, tcols)] = src[r * ld + c];
    }
  }
}

// ---- the message MLP on the tensor cores (kernels 4, 5 and 6 at bf16) ----
//
// A message tile is 64 rows (edges, neighbour slots or nodes) x 64 columns
// (the message width). Its first stage, A [64 x kp] @ W [kp x 64], is
// yk::msg_tile_bf16: one warpgroup issues wgmma m64n64k16 over K in
// ascending k16 steps from a zero accumulator, both operands in the tiled
// shared layout above (A K-major, W MN-major, K zero-padded to kp, a
// multiple of 16). The caller's epilogue (fold, ReLU, round) works on the
// accumulator fragment; yk::msg_stage2_bf16 then hands the rounded
// fragment, as bf16 pairs, to the second stage as its register A operand
// against W2 [64 x 64]: h1 never goes through shared memory. Fragment
// element i of thread (warp w, lane l) is row yk::msg_row(i), column
// yk::msg_col(i). The per-node sum is yk::msg_run_sum over a tile of
// rounded rows kept in shared memory.
constexpr int MSG_H = 64;    // message width
constexpr int MSG_HS = 72;   // row stride (bf16) of a [64 x 64] row tile: rows 4 banks apart
constexpr int MSG_AS = 68;   // row stride (f32) of a [64 x 64] sum tile; 16-byte rows

__device__ __forceinline__ int msg_row(int i) {
  const int lane = threadIdx.x & 31;
  return 16 * (threadIdx.x >> 5) + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int msg_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define YK_D32 YK_D8(0), YK_D8(8), YK_D8(16), YK_D8(24)
#define YK_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " YK_R32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : YK_D32
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// the same with A from registers (the fragment of wgmma_rs)
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " YK_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : YK_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// d = a_s [64, kp] @ w_s [kp, 64] (f32), issued (msg_tile_issue) and
// completed (msg_tile_wait, which completes every product issued before it:
// two tiles' products run back to back). The caller is one whole
// warpgroup, after fence_async_smem and a barrier over the operands' writes.
__device__ __forceinline__ void msg_tile_issue(const __nv_bfloat16* a_s,
                                               const __nv_bfloat16* w_s, int kp,
                                               float (&d)[32]) {
  const uint32_t aa = smem_u32(a_s), wa = smem_u32(w_s);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_acc(d);
  wgmma_fence();
  for (int k = 0; k < kp / 16; ++k)
    wgmma_ss64<0, 1>(d, gmma_desc(aa + k * 256, 128, kp * 16),
                     gmma_desc(wa + k * 16 * MSG_H * 2, 16 * MSG_H, 128), k > 0);
  wgmma_commit();
}
__device__ __forceinline__ void msg_tile_wait(float (&d)[32]) {
  wgmma_wait_all();
  fence_acc(d);
}
__device__ __forceinline__ void msg_tile_bf16(const __nv_bfloat16* a_s,
                                              const __nv_bfloat16* w_s, int kp,
                                              float (&d)[32]) {
  msg_tile_issue(a_s, w_s, kp, d);
  msg_tile_wait(d);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = h @ w2_s [64, 64] (f32), h a first-stage fragment whose values are
// bf16 already (rounded by the epilogue): k16 step kk reads the columns
// 16 kk .. 16 kk + 15, which the fragment holds at elements 8 kk .. 8 kk + 7
__device__ __forceinline__ void msg_stage2_bf16(const float (&h)[32],
                                                const __nv_bfloat16* w2_s,
                                                float (&d)[32]) {
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[kk][q] = bf16_pair(h[8 * kk + 2 * q], h[8 * kk + 2 * q + 1]);
      fence_reg(a[kk][q]);
    }
  const uint32_t wa = smem_u32(w2_s);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs64<1>(d, a[kk], gmma_desc(wa + kk * 16 * MSG_H * 2, 16 * MSG_H, 128), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(d);
}

// Rounding near a bf16 midpoint. A wgmma's f32 sum is not the k-ascending
// FMA chain that the plain versions' f32 products agree with (and that the
// f32 kernels compute), and where a sum lies within a few f32 ulps of a
// midpoint between two bf16 values the two round to neighbouring bf16
// values: one bf16 ulp of a product, which a per-node sum carries to the
// output. So a fragment element that a caller rounds to bf16 is recomputed
// by that chain when it lies within MSG_TIE f32 ulps of a midpoint (about
// 0.4% of them): the rounded value then is the chain's wherever the two
// sums differ by less than MSG_TIE ulps of the result.
constexpr uint32_t MSG_TIE = 128;

__device__ __forceinline__ bool near_bf16_midpoint(float v) {
  return (__float_as_uint(v) & 0xFFFFu) - (0x8000u - MSG_TIE) < 2 * MSG_TIE;
}

// d[i] = sum_k a(row, k) w(k, col), a product with w_s [kp, 64] (tiled,
// zero past k_end), recomputed as the chain over k < k_end from 0 where the
// value the caller rounds, post(i, d[i]), lies near a midpoint (rows <
// `rows` only: the others hold padding); a_group(row, g) is the 16 bytes of
// the A operand's row holding k = 8 g .. 8 g + 7 (bf16, zero past k_end).
// The loads of the next 8 k are issued before the FMAs of these 8.
template <typename A, typename P>
__device__ __forceinline__ void msg_fix_ties(float (&d)[32], A a_group,
                                             const __nv_bfloat16* w_s, int k_end, int rows,
                                             P post) {
  unsigned flags = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    flags |= (unsigned)(msg_row(i) < rows && near_bf16_midpoint(post(i, d[i]))) << i;
  // each lane walks its own flagged elements, the warp's lanes side by
  // side: about one chain per warp and product
  const int groups = (k_end + 7) / 8;
  while (flags) {
    const int i = __ffs(flags) - 1;
    flags &= flags - 1;
    const int row = msg_row(i), col = msg_col(i);
    // w(k, col) for k = 8 g + e: tiled_off(8 g + e, col, 64)
    const __nv_bfloat16* wc = w_s + (col >> 3) * 64 + (col & 7);
    auto load = [&](int g, uint4& av, float (&wv)[8]) {
      av = a_group(row, g);
#pragma unroll
      for (int e = 0; e < 8; ++e) wv[e] = __bfloat162float(wc[g * 8 * MSG_H + e * 8]);
    };
    uint4 av;
    float wv[8];
    load(0, av, wv);
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) {
      uint4 an = av;
      float wn[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) wn[e] = wv[e];
      if (g + 1 < groups) load(g + 1, an, wn);
      const uint32_t u[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (8 * g + e < k_end)
          acc = fmaf(__uint_as_float(e & 1 ? u[e >> 1] & 0xffff0000u : u[e >> 1] << 16),
                     wv[e], acc);
      av = an;
#pragma unroll
      for (int e = 0; e < 8; ++e) wv[e] = wn[e];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j == i) d[j] = acc;
  }
}

// the fragment's (bf16) values into a [64, MSG_HS] bf16 row tile
__device__ __forceinline__ void msg_store_rows(const float (&h)[32], __nv_bfloat16* h_s) {
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<uint32_t*>(h_s + msg_row(i) * MSG_HS + msg_col(i)) =
        bf16_pair(h[i], h[i + 1]);
}

// The per-node sum of one tile, by all 128 threads: rows [0, cnt) of h_s
// belong to nodes node[r] (a node's rows contiguous), and thread (column
// j, half q) walks rows [0, r1) (q = 0) or [r1, cnt) (q = 1), r1 a row
// where a node begins, adding each node's rows one by one, in row order, to
// a running sum that begins as start(r, v, j) (0, or what an earlier tile
// left of node v) and ends in finish(r_end, v, j, sum): the order of a
// sequential loop, with no float atomics.
template <typename Start, typename Finish>
__device__ __forceinline__ void msg_run_sum(const __nv_bfloat16* h_s, const int* node, int r1,
                                            int cnt, Start start, Finish finish) {
  const int j = threadIdx.x & (MSG_H - 1), q = threadIdx.x >> 6;
  const int lo = q ? r1 : 0, hi = q ? cnt : min(r1, cnt);
  int cur = -1;
  float run = 0.f;
  // rows in chunks of 8: the chunk's loads first, then its adds in order
  for (int r0 = lo; r0 < hi; r0 += 8) {
    int v[8];
    float hv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = min(r0 + e, hi - 1);
      v[e] = node[r];
      hv[e] = __bfloat162float(h_s[r * MSG_HS + j]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (r0 + e >= hi) break;
      if (v[e] != cur) {
        if (cur >= 0) finish(r0 + e, cur, j, run);
        cur = v[e];
        run = start(r0 + e, cur, j);
      }
      run += hv[e];
    }
  }
  if (cur >= 0) finish(hi, cur, j, run);
}

// whether p starts on a 16-byte boundary (the launches' condition for
// 16-byte copies)
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// zero n bytes (a multiple of 16) of shared memory
__device__ __forceinline__ void zero_smem(void* p, int n) {
  for (int i = threadIdx.x; i < n / 16; i += WG_THREADS)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

}  // namespace yk
