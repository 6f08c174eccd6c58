// Shared helpers of the yolat_tpu_torch kernels: float <-> storage-type
// conversion (f32 or bf16), rounding to the storage type's precision, and
// the pool head's per-row arithmetic.
#pragma once

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
// the segment-max winners by comparing its recompute with the maximum the
// forward stored, so both must produce the same float bit for bit: one
// fmaf chain per output over k = 0..ci-1 from 0, then fmaf(acc, s0, s1)
// and the ReLU. Both go through these two functions.
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

}  // namespace yk
