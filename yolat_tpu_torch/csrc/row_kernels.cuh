// The pieces of the row kernels (edge_window_train.cu: kernels 9, 10 and, on
// kernel 10's body, 8 and 8b; banded_train.cu: kernel 7b): gathers and
// fixed-order sums of whole rows, with no product, so bound by bytes.
//
// Two routes, which `launch` chooses from c, the type and the pointers:
//   * 16-byte route: a row is a whole number of 16-byte pieces (8 bf16 or 4
//     f32 channels), 1 to 32 of them, and every value array starts on a
//     16-byte boundary. A group of 2^lg lanes (the least power of two >= the
//     pieces in a row) serves one row; each lane moves one piece by one
//     ld.global.nc 16-byte load and one 16-byte store, and keeps one f32
//     accumulator per channel of its piece. The group reads its row's
//     indices once, by broadcast loads.
//   * narrow route: any other c or an unaligned view; one thread per row
//     and a loop over the channels.
// All index arithmetic is int: the wrappers hold every value array below
// 2^31 elements.
//
// Included by the two sources above; each gets its own copy (anonymous
// namespace), so their kernels keep internal linkage.
#pragma once

#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // a block's threads, unless a kernel names others
constexpr int MAX_THREADS = 132 * 16 * THREADS;  // a grid's, at most

// blocks of `block` threads for `rows` rows, `per_block` rows a block
int blocks_for(int rows, int per_block, int block) {
  const int b = (rows + per_block - 1) / per_block;
  return b < 1 ? 1 : (b > MAX_THREADS / block ? MAX_THREADS / block : b);
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// ---- 16-byte pieces: K = 16 / sizeof(T) channels ----

template <typename T> struct Piece {
  static constexpr int K = 16 / (int)sizeof(T);
};

__device__ __forceinline__ uint4 ld16(const uint4* p) { return __ldg(p); }

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
// bf16 -> f32 is exact: the bf16 bits are the high half of the float
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 pack(const float (&f)[Piece<T>::K]);
template <> __device__ __forceinline__ uint4 pack<float>(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
// round to nearest even, as yk::from_f
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float (&f)[8]) {
  return make_uint4(yk::bf16_pair(f[0], f[1]), yk::bf16_pair(f[2], f[3]),
                    yk::bf16_pair(f[4], f[5]), yk::bf16_pair(f[6], f[7]));
}

template <typename T>
__device__ __forceinline__ void add_piece(float (&acc)[Piece<T>::K], const uint4& a) {
  float fa[Piece<T>::K];
  unpack(a, fa);
#pragma unroll
  for (int k = 0; k < Piece<T>::K; ++k) acc[k] += fa[k];
}

// The 16-byte route's group: pieces p = c / K per row (K channels a piece),
// 1 <= p <= 32, lanes 2^lg >= p. False where a row of c values is not such.
template <typename T> bool vector_shape(int c, int* lg) {
  constexpr int K = Piece<T>::K;
  if (c % K != 0 || c / K < 1 || c / K > 32) return false;
  *lg = 0;
  while ((1 << *lg) < c / K) ++*lg;
  return true;
}

// Launch a row kernel in blocks of BLOCK threads on the 16-byte route where c
// makes a row whole pieces and every value array in `vals` starts on a
// 16-byte boundary (one group of 2^lg lanes per row), else on the narrow
// route (`items` threads: rows, or kernel 9 forward's row elements).
template <typename T, int BLOCK = THREADS, typename KV, typename KN, typename... A>
int launch(KV vec_kernel, KN narrow_kernel, std::initializer_list<const void*> vals,
           int rows, int items, int c, cudaStream_t st, A... args) {
  int lg;
  bool vec = vector_shape<T>(c, &lg);
  for (const void* p : vals) vec = vec && yk::aligned16(p);
  if (vec)
    vec_kernel<<<blocks_for(rows, BLOCK >> lg, BLOCK), BLOCK, 0, st>>>(args..., lg);
  else
    narrow_kernel<<<blocks_for(items, BLOCK, BLOCK), BLOCK, 0, st>>>(args..., 0);
  return (int)cudaGetLastError();
}

}  // namespace
