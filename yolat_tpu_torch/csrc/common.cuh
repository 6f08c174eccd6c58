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

// zero n bytes (a multiple of 16) of shared memory
__device__ __forceinline__ void zero_smem(void* p, int n) {
  for (int i = threadIdx.x; i < n / 16; i += WG_THREADS)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

}  // namespace yk
