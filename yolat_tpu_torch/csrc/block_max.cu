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
// W is read in x's type. z = x @ W comes from yk::pool_z_tile_bf16 at bf16
// and yk::mlp_rows8x4 at f32 (common.cuh), which the training backward
// (fused_pool_train.cu) recomputes through to find the max's winners.
//
// What bounds it on the H100: at the bench batch (N 72704, CI 128,
// H 1024) the product is 19.1 GFLOP against ~19 MB of x and ~19 MB of
// output at bf16, so the arithmetic bounds it (0.0193 ms on the bf16
// tensor cores); the [N, 1024] f32 intermediate it keeps on chip would be
// ~300 MB each way.
//
// bf16, on the tensor cores (block_max_tc_kernel): one warpgroup per CTA;
// a CTA keeps one 128-column W slab in shared memory and walks a chunk of
// 64-row x tiles (grid: H/128 slabs x as many chunks as fill the card
// once), the next tile's cp.async copy in flight while this one computes.
// Per tile: z [64 x 128] by the shared routine (wgmma m64n128k16, K =
// CI rounded up to 16 and zero-padded), then the epilogue in registers:
// folded_pre, ReLU, the -1e30 mask, rounding to bf16 (rounding is monotone,
// so the max of the rounded values is the rounded max), and the block max
// over the 8 lanes that hold one column of one pool block (lane bits 2-4,
// bf16 pairs, a reduce-scatter: 28 shuffles a thread); the [8 x 128] result
// goes out in 16-byte stores through shared memory. The column-slab-0
// CTAs also write the x block max from the staged tile, exactly (bf16
// pairs, 16-byte pieces when CI % 8 == 0). Measured on the H100 at the
// bench batch (scripts/pool_head_decomp.py), ~10% of the bound: without
// the product the kernel is within 10% as fast, without the epilogue ~40%
// faster, without the next tile's copy ~20% faster, so the tile's serial
// chain (copy, barriers, a 64-element epilogue per thread on three
// warpgroups per SM) bounds it, not the tensor cores. Not yet: TMA, a
// swizzled layout, a producer warp, the epilogue overlapped with the next
// tile's product.
//
// f32 (block_max_kernel; IEEE FMA on the CUDA cores, no TF32): one CTA per
// 64-row x 128-column output tile, x tile and W slab staged as f32; each
// thread owns one 8-row block x 4 columns, so its 32 FMA accumulators hold
// whole pool blocks and the epilogue needs no cross-thread reduction.
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
  extern __shared__ __align__(128) unsigned char smem_raw[];
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

// ---- bf16 on the tensor cores ----
using bf16 = __nv_bfloat16;

// W slab [kp, 128], two x tiles [64, kp], two masks [64] f32, sc slab
// [2, 128] f32, the outh tile [8, 128] bf16
size_t tc_smem_bytes(int kp) {
  return (size_t)kp * COLS * 2 + 2 * (size_t)ROWS * kp * 2 + 2 * ROWS * 4 + 2 * COLS * 4 +
         BLOCK * COLS * 2;
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(unsigned u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__global__ void __launch_bounds__(yk::WG_THREADS) block_max_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ mask, const bf16* __restrict__ w,
    const float* __restrict__ sc, bf16* __restrict__ outh, bf16* __restrict__ outx, int ci,
    int h, int tiles, int per, int vec_x, int vec_w) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kp = (ci + 15) & ~15;
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);              // [kp, COLS]
  bf16* x_s = w_s + kp * COLS;                                // 2 x [ROWS, kp]
  float* m_s = reinterpret_cast<float*>(x_s + 2 * ROWS * kp);  // 2 x [ROWS]
  float* sc_s = m_s + 2 * ROWS;                               // [2, COLS]
  bf16* o_s = reinterpret_cast<bf16*>(sc_s + 2 * COLS);       // [BLOCK, COLS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int col0 = blockIdx.x * COLS;
  const int t0 = blockIdx.y * per, t1 = min(t0 + per, tiles);
  if (t0 >= t1) return;
  yk::zero_smem(smem_raw, (kp * COLS + 2 * ROWS * kp) * 2);  // the K padding
  __syncthreads();
  yk::load_tiled(w_s, w + col0, h, ci, COLS, COLS, vec_w);
  for (int i = tid; i < 2 * COLS; i += yk::WG_THREADS)
    sc_s[i] = sc[(i / COLS) * h + col0 + i % COLS];
  auto load_tile = [&](int t, int buf) {
    yk::load_tiled(x_s + buf * ROWS * kp, x + (size_t)t * ROWS * ci, ci, ROWS, ci, kp, vec_x);
    if (tid < ROWS) yk::cp_async4(m_s + buf * ROWS + tid, mask + (size_t)t * ROWS + tid);
    yk::cp_async_commit();
  };
  load_tile(t0, 0);

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
    const bf16* xt = x_s + buf * ROWS * kp;
    const float* mt = m_s + buf * ROWS;
    float z[64];
    yk::pool_z_tile_bf16(xt, w_s, kp, z);

    // rows 16 warp + g (block 2 warp) and + 8 (block 2 warp + 1); p[2j + b]:
    // block 2 warp + b, columns 8j + 2 t4 and + 1, as a bf16 pair
    const bool in0 = mt[16 * warp + g] > 0.f, in1 = mt[16 * warp + 8 + g] > 0.f;
    unsigned p[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 s0 = *reinterpret_cast<const float2*>(sc_s + c);
      const float2 s1 = *reinterpret_cast<const float2*>(sc_s + COLS + c);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = fmaxf(yk::folded_pre(z[4 * j + e], (e & 1) ? s0.y : s0.x,
                                    (e & 1) ? s1.y : s1.x), 0.f);
        if (!((e & 2) ? in1 : in0)) v[e] = -1e30f;
      }
      p[2 * j] = as_u32(__floats2bfloat162_rn(v[0], v[1]));
      p[2 * j + 1] = as_u32(__floats2bfloat162_rn(v[2], v[3]));
    }
    // the max over each block's 8 rows: lane g keeps p of j = 2g, 2g + 1
    yk::reduce_scatter8(p, [](unsigned a, unsigned b) {
      return as_u32(__hmax2(as_bf2(a), as_bf2(b)));
    });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 2 * g + i / 2, b = 2 * warp + (i & 1);
      *reinterpret_cast<unsigned*>(o_s + b * COLS + 8 * j + 2 * t4) = p[i];
    }
    __syncthreads();
    {  // [BLOCK, COLS] bf16: one 16-byte store per thread
      const int b = tid / 16, q = tid % 16;
      *reinterpret_cast<uint4*>(outh + ((size_t)t * BLOCK + b) * h + col0 + q * 8) =
          *reinterpret_cast<const uint4*>(o_s + b * COLS + q * 8);
    }
    if (outx != nullptr && blockIdx.x == 0 && vec_x) {
      // 8 columns of one block per item: 16-byte shared loads (one core
      // matrix row) and a 16-byte store; the max over bf16 pairs is exact
      const __nv_bfloat162 masked = __float2bfloat162_rn(-1e30f);
      const int nc = ci / 8;
      for (int i = tid; i < BLOCK * nc; i += yk::WG_THREADS) {
        const int b = i / nc, c = (i - b * nc) * 8;
        __nv_bfloat162 mx[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[q] = __float2bfloat162_rn(-INFINITY);
#pragma unroll
        for (int r = 0; r < BLOCK; ++r) {
          const int row = b * BLOCK + r;
          const uint4 v = *reinterpret_cast<const uint4*>(xt + yk::tiled_off(row, c, kp));
          const bool in = mt[row] > 0.f;
          mx[0] = __hmax2(mx[0], in ? as_bf2(v.x) : masked);
          mx[1] = __hmax2(mx[1], in ? as_bf2(v.y) : masked);
          mx[2] = __hmax2(mx[2], in ? as_bf2(v.z) : masked);
          mx[3] = __hmax2(mx[3], in ? as_bf2(v.w) : masked);
        }
        *reinterpret_cast<uint4*>(outx + ((size_t)t * BLOCK + b) * ci + c) =
            make_uint4(as_u32(mx[0]), as_u32(mx[1]), as_u32(mx[2]), as_u32(mx[3]));
      }
    } else if (outx != nullptr && blockIdx.x == 0) {
      const float masked = yk::round_to<bf16>(-1e30f);
      for (int i = tid; i < BLOCK * ci; i += yk::WG_THREADS) {
        const int b = i / ci, cc = i - b * ci;
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < BLOCK; ++r) {
          const int row = b * BLOCK + r;
          mx = fmaxf(mx, mt[row] > 0.f ? yk::to_f(xt[yk::tiled_off(row, cc, kp)]) : masked);
        }
        outx[((size_t)t * BLOCK + b) * ci + cc] = yk::from_f<bf16>(mx);
      }
    }
    __syncthreads();  // this tile's buffers and o_s are free
  }
}

int launch_tc(const void* x, const void* mask, const void* w, const void* sc, void* outh,
              void* outx, int n, int ci, int h, cudaStream_t stream) {
  const int kp = (ci + 15) & ~15;
  const size_t smem = tc_smem_bytes(kp);
  cudaError_t err = cudaFuncSetAttribute(
      block_max_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, block_max_tc_kernel, yk::WG_THREADS, smem)) != cudaSuccess)
    return (int)err;
  // as many row chunks per slab as fill the card once
  const int slabs = h / COLS, tiles = n / ROWS;
  const int fit = max(1, sms * max(per_sm, 1) / slabs);
  const int per = (tiles + fit - 1) / fit;
  const int chunks = (tiles + per - 1) / per;
  block_max_tc_kernel<<<dim3(slabs, chunks), yk::WG_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(mask),
      static_cast<const bf16*>(w), static_cast<const float*>(sc), static_cast<bf16*>(outh),
      static_cast<bf16*>(outx), ci, h, tiles, per, ci % 8 == 0 && yk::aligned16(x),
      yk::aligned16(w));
  return (int)cudaGetLastError();
}

// ---- f32: IEEE FMA ----
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

// x [n, ci] (f32, or bf16 when bf16 != 0: the tensor-core kernel), mask
// [n] f32, w [ci, h] in x's type, sc [2, h] f32 -> outh [n/8, h], outx
// [n/8, ci] in x's type (outh, and outx when ci % 8 == 0, 16-byte aligned).
// Requires n % 64 == 0 and h % 128 == 0. Returns the CUDA error code of
// the launch.
int yk_folded_mlp_block_max2(const void* x, const void* mask, const void* w,
                             const void* sc, void* outh, void* outx, int n,
                             int ci, int h, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_tc(x, mask, w, sc, outh, outx, n, ci, h, st);
  return launch<float>(x, mask, w, sc, outh, outx, n, ci, h, st);
}

// The single-output form (no x block max): the same kernel, outx null.
int yk_folded_mlp_block_max(const void* x, const void* mask, const void* w,
                            const void* sc, void* outh, int n, int ci, int h,
                            int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_tc(x, mask, w, sc, outh, nullptr, n, ci, h, st);
  return launch<float>(x, mask, w, sc, outh, nullptr, n, ci, h, st);
}

// the larger of the two kernels' shared memory (the f32 one for every ci)
long yk_block_max_smem_bytes(int ci) {
  const size_t a = smem_bytes(ci), b = tc_smem_bytes((ci + 15) & ~15);
  return (long)(a > b ? a : b);
}

}  // extern "C"
