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
// The recompute goes through yk::mlp_rows8x4 / yk::folded_pre, the very
// arithmetic of the forward kernel (block_max.cu), so a winner's relu(y)
// equals the stored maximum bit for bit; at bf16 it is rounded to the
// stored type before the compare.
//
// What bounds it on the H100: four products of the size of the forward's
// (z twice, x^T s, s @ W^T: ~76 GFLOP at the bench batch, N 72704, CI 128,
// H 1024) against ~20 MB of inputs at bf16, so the arithmetic bounds it.
// The [N, H] u, s and z never go to device memory. The TPU kernel carries
// dW and the u-sums across its sequential grid; CTAs here run in no order,
// and no float atomics are used (two runs give identical bits):
//   * pass A, one CTA per 64-row tile: loops over H in slabs of 128,
//     recomputes z for the slab (8 rows x 4 columns per thread, as the
//     forward), forms u and s, keeps s in shared memory and accumulates
//     dx_tile += s_slab @ W_slab^T in registers; writes dx_s once and the
//     tile's column sums of u and u*z, reduced in a fixed order, as
//     partials [N/64, 2, H];
//   * pass B, a grid of (H slab x chunk of tiles): recomputes s for each
//     tile of its chunk and accumulates x^T s into partials [K, CI, H];
//   * pass C sums the partials in a fixed order.
// CUDA-core FMA only; wgmma, TMA and fusing the passes are later work.
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
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

// x [n, ci] (f32, or bf16 when bf16 != 0), mask [n] f32, w [ci, h] in x's
// type, sc [2, h] f32, pooled_b [n/8, h] in x's type, gp_b [n/8, h] f32 ->
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
    return launch<__nv_bfloat16>(x, mask, w, sc, pooled_b, gp_b, dw_u, dx_s, sums, part_u,
                                 part_w, n, ci, h, kchunks, st);
  return launch<float>(x, mask, w, sc, pooled_b, gp_b, dw_u, dx_s, sums, part_u, part_w, n,
                       ci, h, kchunks, st);
}

long yk_fused_pool_train_smem_bytes(int ci) {
  const size_t a = smem_rows(ci), b = smem_dw(ci);
  return (long)(a > b ? a : b);
}

}  // extern "C"
