// Trainable banded ops for sm_90a: the endpoint-row gather of one edge family
// and its backward, the sum of the cotangents at both endpoints (kernels 7
// and 7b). The per-node sum at the sorted endpoint and its backward
// (kernels 8 and 8b) compute kernel 10's two functions over this plan and
// run its kernels: their entries are in edge_window_train.cu.
//
// Replaces: yolat_tpu/ops/banded_train.py
//   banded_gather       (_gather_kernel :64, pallas_call at :143; its VJP
//                        _gather_bwd :294 = _scatter_call :216 twice, the
//                        _scatter_kernel :157 with pallas_call at :257 and the
//                        spill-tile combination at :264-272)
// over the plan of ops/plans.banded_plan(transpose=True): the family's E real
// edges sorted by the endpoint `own`, absolute node rows own/oth [E], the
// per-node offsets nptr [n + 1] of that list, and its transpose by the other
// endpoint, tperm [E] (the rows stably sorted by oth) with offsets tptr [n + 1].
//   7   x_own[r] = x[own r],  x_oth[r] = x[oth r]                  (x's type)
//   7b  dx[v] = sum_{own r = v} g_own[r] + sum_{oth r = v} g_oth[r]
//               (two f32 sums, added, rounded to x's type)
// Rounding follows the TPU kernels: a gathered row is a copy, exact in any
// type (they return it in f32 and the caller rounds it back); 7b sums its
// terms in f32, the own run in nptr order and the other run in tperm order,
// each from 0, and rounds once at the end, after adding the two sums as
// own + other (:298-300).
//
// What bounds them on the H100: bytes. Each moves O(E * C) values once and
// adds at most once per value. The TPU kernels turn each gather and each sum
// into one-hot MXU contractions of 256-row edge blocks against a 512-node
// window with 128-row halos, pad the list to whole blocks with masked rows,
// and collect the other endpoint's sums in spill tiles, because a TPU has no
// fast row gather and no scatter. Hopper reads rows directly, so none of that
// is carried over, and there is no masked row:
//   * 7, the gather: one thread per 16 bytes of the output where a row is a
//     whole number of 16-byte units, else per element; consecutive threads on
//     consecutive addresses of one row; 64-bit indices;
//   * 7b, the sums, on the row kernels' routes (row_kernels.cuh). The clique
//     family is lower-triangular all-pairs per proposal, so a node's runs
//     are anything from 0 to tens of rows, and the time is set by chains of
//     dependent misses (the offsets, the first tperm indices, then each
//     step of a run) over the nodes in flight. On the 16-byte route a group
//     of 2^lg lanes serves one node: it reads nptr[v], nptr[v + 1], tptr[v],
//     tptr[v + 1] once by broadcast, then walks the own run (contiguous
//     rows) and the other run (through tperm) side by side, STEP rows of
//     each in flight before any is added, so that a node's chain is its
//     longer run over STEP. The next STEP tperm indices are loaded before
//     the current rows are added, and kept as loaded until the next step
//     forms its addresses: clamping them right after the load let the
//     compiler wait for the index before requesting the rows. A lane keeps
//     K f32 accumulators per sum and stores one 16-byte piece. Rows in
//     flight per lane set the time more than threads in flight: two rows a
//     step, or the two runs one after the other, read slower at full
//     occupancy; so 7b runs 128-thread blocks with registers enough for
//     its rows in flight (bwd_blocks). The narrow route is one thread per node and a loop over the
//     channels. A node's sums are formed by one lane (per piece) or one
//     thread in a fixed order, in registers: no float atomics,
//     bit-identical across runs, and every output row is written once.
#include "row_kernels.cuh"

namespace {

constexpr int GATHER_MAX_BLOCKS = 132 * 64;
// 7b: rows of each run a lane keeps in flight, and its blocks: 128 threads,
// 7 blocks a SM at bf16 (72 registers a thread, which its 16-byte route
// needs without a spill) and 8 at f32 (64: left unbounded, ptxas gives the
// f32 route 40 and fewer rows in flight)
constexpr int STEP = 4;
constexpr int BWD_THREADS = 128;
template <typename T> constexpr int bwd_blocks() { return sizeof(T) == 2 ? 7 : 8; }

int gather_blocks(long total) {
  long b = (total + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > GATHER_MAX_BLOCKS ? GATHER_MAX_BLOCKS : b));
}

// Kernel 7. V is the copy unit: uint4 when a row is a whole number of
// 16-byte units, else the element type; vpr units per row. Rows are clamped
// into range for memory safety only: banded_plan rejects endpoints outside
// [0, n).
template <typename V>
__global__ void __launch_bounds__(THREADS) gather_pair_kernel(
    const V* __restrict__ x, const int* __restrict__ own, const int* __restrict__ oth,
    V* __restrict__ out_own, V* __restrict__ out_oth, int n, int e, int vpr) {
  const long total = (long)e * vpr;
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const int r = (int)(i / vpr), q = (int)(i - (long)r * vpr);
    out_own[i] = x[(size_t)clampi(own[r], n - 1) * vpr + q];
    out_oth[i] = x[(size_t)clampi(oth[r], n - 1) * vpr + q];
  }
}

// Kernel 7b; lg: log2 of the lanes a node's group has (16-byte route). Rows
// are clamped into range for memory safety only: banded_plan rejects
// endpoints outside [0, n).
template <typename T, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, bwd_blocks<T>()) gather_bwd_kernel(
    const T* __restrict__ g_own, const T* __restrict__ g_oth,
    const int* __restrict__ nptr, const int* __restrict__ tperm,
    const int* __restrict__ tptr, T* __restrict__ dx, int n, int e, int c, int lg) {
  if constexpr (VEC) {
    constexpr int K = Piece<T>::K;
    const int p = c / K, pc = threadIdx.x & ((1 << lg) - 1);
    const int per = BWD_THREADS >> lg;
    const uint4* own_in = reinterpret_cast<const uint4*>(g_own) + pc;
    const uint4* oth_in = reinterpret_cast<const uint4*>(g_oth) + pc;
    for (int v = blockIdx.x * per + (threadIdx.x >> lg); v < n; v += gridDim.x * per) {
      if (pc >= p) continue;
      int i = clampi(__ldg(nptr + v), e), q = clampi(__ldg(tptr + v), e);
      const int i1 = clampi(__ldg(nptr + v + 1), e), q1 = clampi(__ldg(tptr + v + 1), e);
      // the other run's next rows, as loaded: each is clamped where the
      // next step forms its address, so that no instruction waits for the
      // index before this step's rows are requested (a clamp right after
      // the load let the compiler do just that: two misses a step)
      int r[STEP];
#pragma unroll
      for (int j = 0; j < STEP; ++j) r[j] = q + j < q1 ? __ldg(tperm + q + j) : 0;
      float a[K], b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] = b[k] = 0.f;
      for (; i < i1 || q < q1; i += STEP, q += STEP) {
        uint4 ga[STEP], gb[STEP];
#pragma unroll
        for (int j = 0; j < STEP; ++j) {
          ga[j] = i + j < i1 ? ld16(own_in + (i + j) * p) : make_uint4(0, 0, 0, 0);
          gb[j] = q + j < q1 ? ld16(oth_in + clampi(r[j], e - 1) * p) : make_uint4(0, 0, 0, 0);
        }
        // the next rows' indices before these rows are added
#pragma unroll
        for (int j = 0; j < STEP; ++j)
          r[j] = q + STEP + j < q1 ? __ldg(tperm + q + STEP + j) : 0;
#pragma unroll
        for (int j = 0; j < STEP; ++j) {
          if (i + j < i1) add_piece<T>(a, ga[j]);
          if (q + j < q1) add_piece<T>(b, gb[j]);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] += b[k];
      reinterpret_cast<uint4*>(dx)[v * p + pc] = pack<T>(a);
    }
  } else {
    constexpr int CH = 8;  // channels a thread sums at once
    for (int v = blockIdx.x * BWD_THREADS + threadIdx.x; v < n;
         v += gridDim.x * BWD_THREADS) {
      const int i0 = clampi(nptr[v], e), i1 = clampi(nptr[v + 1], e);
      const int q0 = clampi(tptr[v], e), q1 = clampi(tptr[v + 1], e);
      for (int k0 = 0; k0 < c; k0 += CH) {
        float a[CH], b[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) a[j] = b[j] = 0.f;
        for (int i = i0; i < i1; ++i) {
          const T* row = g_own + i * c + k0;
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (k0 + j < c) a[j] += yk::to_f(row[j]);
        }
        for (int q = q0; q < q1; ++q) {
          const T* row = g_oth + clampi(tperm[q], e - 1) * c + k0;
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (k0 + j < c) b[j] += yk::to_f(row[j]);
        }
#pragma unroll
        for (int j = 0; j < CH; ++j)
          if (k0 + j < c) dx[v * c + k0 + j] = yk::from_f<T>(a[j] + b[j]);
      }
    }
  }
}

template <typename T>
int gather_bwd(const void* g_own, const void* g_oth, const void* nptr, const void* tperm,
               const void* tptr, void* dx, int n, int e, int c, cudaStream_t st) {
  return launch<T, BWD_THREADS>(gather_bwd_kernel<T, true>, gather_bwd_kernel<T, false>,
                   {g_own, g_oth, dx}, n, n, c, st, static_cast<const T*>(g_own),
                   static_cast<const T*>(g_oth), static_cast<const int*>(nptr),
                   static_cast<const int*>(tperm), static_cast<const int*>(tptr),
                   static_cast<T*>(dx), n, e, c);
}

template <typename V>
int launch_gather(const void* x, const void* own, const void* oth, void* out_own,
                  void* out_oth, int n, int e, int vpr, cudaStream_t st) {
  gather_pair_kernel<V><<<gather_blocks((long)e * vpr), THREADS, 0, st>>>(
      static_cast<const V*>(x), static_cast<const int*>(own),
      static_cast<const int*>(oth), static_cast<V*>(out_own),
      static_cast<V*>(out_oth), n, e, vpr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel 7. x [n, c] (f32, or bf16 when bf16 != 0); own/oth [e] i32;
// out_own/out_oth [e, c] in x's type. Each entry point returns the CUDA
// error code of its launch.
int yk_banded_gather(const void* x, const void* own, const void* oth, void* out_own,
                     void* out_oth, int n, int e, int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_bytes = c * (bf16 ? 2 : 4);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out_own) |
                         reinterpret_cast<uintptr_t>(out_oth);
  if (row_bytes % 16 == 0 && ptrs % 16 == 0)
    return launch_gather<uint4>(x, own, oth, out_own, out_oth, n, e, row_bytes / 16, st);
  if (bf16)
    return launch_gather<__nv_bfloat16>(x, own, oth, out_own, out_oth, n, e, c, st);
  return launch_gather<float>(x, own, oth, out_own, out_oth, n, e, c, st);
}

// Kernel 7b. g_own/g_oth [e, c] (f32 or bf16); nptr/tptr [n + 1] i32; tperm
// [e] i32; dx [n, c] in g's type.
int yk_banded_gather_bwd(const void* g_own, const void* g_oth, const void* nptr,
                         const void* tperm, const void* tptr, void* dx, int n, int e,
                         int c, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? gather_bwd<__nv_bfloat16>(g_own, g_oth, nptr, tperm, tptr, dx, n, e, c, st)
              : gather_bwd<float>(g_own, g_oth, nptr, tperm, tptr, dx, n, e, c, st);
}

}  // extern "C"
