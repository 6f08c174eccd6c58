// Fused fusion-MLP + 8-row block max (the pool head), for sm_90a.
//
// Replaces: yolat_tpu/ops/pallas_kernels.py, folded_mlp_block_max2
// (`_folded_mlp_block_max2_kernel`, pallas_call at :306; the serving head)
// and folded_mlp_block_max (`_folded_mlp_block_max_kernel`, pallas_call at
// :247; the forward of the fused training pool head). For x [N, CI],
// node mask m [N], W [CI, H], sc [2, H]:
//   outh[b] = max over rows r of block b of (m[r] > 0 ? relu((x[r] @ W) *
//             sc[0] + sc[1]) : -1e30)                        [N/8, H]
//   outx[b] = max over rows r of block b of (m[r] > 0 ? x[r] : -1e30)
//                                                            [N/8, CI]
// (outx only for folded_mlp_block_max2), stored in x's type (f32 or bf16);
// the [N, H] MLP output never leaves the chip. Products and sums are f32,
// W is read in x's type. The per-row arithmetic is yk::mlp_rows8x4 and
// yk::folded_pre (common.cuh), which the training backward
// (fused_pool_train.cu) recomputes through to find the max's winners.
//
// What bounds it on the H100: at the bench batch (N 72704, CI 128,
// H 1024) the product is 19.1 GFLOP against ~19 MB of x and ~19 MB of
// output at bf16, so the arithmetic bounds it; the [N, 1024] f32
// intermediate it keeps on chip would be ~300 MB each way. Design:
//   * one CTA per 64-row x 128-column output tile (a multiple of the
//     8-row pool block); the x tile and the W column slab are staged in
//     shared memory as f32;
//   * each thread owns one 8-row block x 4 columns, so its 32 f32 FMA
//     accumulators hold whole pool blocks: the epilogue (scale/shift, relu,
//     mask to -1e30, max over the 8 rows) runs in registers with no
//     cross-thread reduction;
//   * x values are broadcast across a warp (all lanes share the 8 rows),
//     W is read as float4 rows (conflict-free);
//   * with outx, the column-slab-0 CTAs also write the x block max from the
//     staged tile.
// CUDA-core FMA only; mma.sync / wgmma with TMA staging are later work.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;      // rows per CTA (8 pool blocks)
constexpr int COLS = 128;     // output columns per CTA
constexpr int THREADS = 256;  // 8 row blocks x 32 column groups of 4
constexpr int BLOCK = yk::POOL_BLOCK;

size_t smem_bytes(int ci) { return ((size_t)ROWS * ci + (size_t)ci * COLS + ROWS) * 4; }

template <typename T>
__global__ void __launch_bounds__(THREADS) block_max_kernel(
    const T* __restrict__ x, const float* __restrict__ mask,
    const T* __restrict__ w, const float* __restrict__ sc,
    T* __restrict__ outh, T* __restrict__ outx, int ci, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);  // [ROWS, ci]
  float* w_s = x_s + ROWS * ci;                     // [ci, COLS]
  float* m_s = w_s + ci * COLS;                     // [ROWS]

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const int col0 = blockIdx.y * COLS;
  for (int i = tid; i < ROWS * ci; i += THREADS) x_s[i] = yk::to_f(x[row0 * ci + i]);
  for (int i = tid; i < ci * COLS; i += THREADS) {
    const int kk = i / COLS, cc = i - kk * COLS;
    w_s[i] = yk::to_f(w[(size_t)kk * h + col0 + cc]);
  }
  if (tid < ROWS) m_s[tid] = mask[row0 + tid];
  __syncthreads();

  const int rb = tid / 32, cg = tid % 32;
  float acc[BLOCK][4];
  yk::mlp_rows8x4(x_s + rb * BLOCK * ci, ci, w_s + cg * 4, COLS, acc);
  const size_t blk = (size_t)blockIdx.x * (ROWS / BLOCK) + rb;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = col0 + cg * 4 + q;
    const float s0 = sc[col], s1 = sc[h + col];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < BLOCK; ++r) {
      const float v = fmaxf(yk::folded_pre(acc[r][q], s0, s1), 0.f);
      mx = fmaxf(mx, m_s[rb * BLOCK + r] > 0.f ? v : -1e30f);
    }
    outh[blk * h + col] = yk::from_f<T>(mx);
  }

  if (outx != nullptr && blockIdx.y == 0) {
    const float masked = yk::round_to<T>(-1e30f);
    for (int i = tid; i < (ROWS / BLOCK) * ci; i += THREADS) {
      const int b = i / ci, cc = i - b * ci;
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < BLOCK; ++r) {
        const int row = b * BLOCK + r;
        mx = fmaxf(mx, m_s[row] > 0.f ? x_s[row * ci + cc] : masked);
      }
      outx[((size_t)blockIdx.x * (ROWS / BLOCK) + b) * ci + cc] = yk::from_f<T>(mx);
    }
  }
}

template <typename T>
int launch(const void* x, const void* mask, const void* w, const void* sc,
           void* outh, void* outx, int n, int ci, int h, cudaStream_t stream) {
  const size_t smem = smem_bytes(ci);
  cudaError_t err = cudaFuncSetAttribute(
      block_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / ROWS, h / COLS);
  block_max_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const T*>(w), static_cast<const float*>(sc),
      static_cast<T*>(outh), static_cast<T*>(outx), ci, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, ci] (f32, or bf16 when bf16 != 0), mask [n] f32, w [ci, h] in x's
// type, sc [2, h] f32 -> outh [n/8, h], outx [n/8, ci] in x's type.
// Requires n % 64 == 0 and h % 128 == 0. Returns the CUDA error code of
// the launch.
int yk_folded_mlp_block_max2(const void* x, const void* mask, const void* w,
                             const void* sc, void* outh, void* outx, int n,
                             int ci, int h, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, mask, w, sc, outh, outx, n, ci, h, st);
  return launch<float>(x, mask, w, sc, outh, outx, n, ci, h, st);
}

// The single-output form (no x block max): the same kernel, outx null.
int yk_folded_mlp_block_max(const void* x, const void* mask, const void* w,
                            const void* sc, void* outh, int n, int ci, int h,
                            int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, mask, w, sc, outh, nullptr, n, ci, h, st);
  return launch<float>(x, mask, w, sc, outh, nullptr, n, ci, h, st);
}

long yk_block_max_smem_bytes(int ci) { return (long)smem_bytes(ci); }

}  // extern "C"
