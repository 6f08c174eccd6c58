// The NMS fixed point on the device, for sm_90a: one thread block per problem
// iterates kept = valid & ~any_j(j suppresses i & kept[j]) from kept = valid
// until no entry changes (kernel N1).
//
// Replaces no TPU kernel: it is the counterpart of XLA's lax.while_loop in
// yolat_tpu/ops/nms.py:211 (`_fixpoint_nms`) and :297 (`_class_fixpoint_nms`),
// which the port ran as a host loop with one read-back per sweep, so that a
// serving step could not be captured as a CUDA graph.
//   fixpoint   problem = image b: sup [B, C, C] bool, sup[b, i, j] = candidate
//              j outranks i and overlaps it (strictly lower triangular);
//              valid [B, C] bool; kept [B, C] bool.
//   classfix   problem = (image b, class k): ovt [B, M, M] bool, ovt[b, i, j]
//              = box j overlaps box i (the IoU test transposed); rank
//              [B, K, M] i32; cand [B, K, M] bool; j suppresses i when
//              kept[j] and ovt[b, i, j] and rank[j] < rank[i]; kept
//              [B, K, M] bool.
// Suppression comes only from a better rank, so the fixed point is unique:
// these sweeps (all rows from the previous sweep's set, as the plain loop of
// ops/nms_fixpoint.py takes them) end on the plain loop's booleans.
//
// What bounds it on the H100: bytes, and the dependence between sweeps. A
// sweep reads each valid row of the relation at most once (C x C bytes for an
// image, from L2 after the first sweep), and sweeps are sequential, so one
// block per problem keeps the kept set in shared memory and needs no barrier
// across the grid. A warp takes one row: each lane ANDs 16 bytes of the row
// with 16 bytes of the kept set (bools are 0 / 1 bytes; one byte per lane
// where the width or the base is not 16-byte aligned), and the warp stops at
// the first hit, which for a suppressed box is usually among the best ranked.
// Rows whose own entry is not valid are never read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline long align16(long n) { return (n + 15) / 16 * 16; }

// Whether some j in [0, c) has row[j] and kept[j] and pred(j); every lane of
// the warp calls it with the same row and gets the same answer.
template <bool VEC, typename Pred>
__device__ __forceinline__ bool warp_any_hit(const uint8_t* __restrict__ row,
                                             const uint8_t* kept, int c, int lane,
                                             Pred pred) {
  constexpr int W = VEC ? 16 : 1;
  for (int base = 0; base < c; base += 32 * W) {
    const int j0 = base + lane * W;
    bool hit = false;
    if (j0 < c) {
      if (VEC) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(row + j0));
        const uint4 k = *reinterpret_cast<const uint4*>(kept + j0);
        const uint32_t w[4] = {r.x & k.x, r.y & k.y, r.z & k.z, r.w & k.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (w[q] == 0) continue;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (((w[q] >> (8 * t)) & 0xffu) && pred(j0 + 4 * q + t)) hit = true;
        }
      } else {
        hit = row[j0] && kept[j0] && pred(j0);
      }
    }
    if (__any_sync(FULL, hit)) return true;
  }
  return false;
}

// The sweeps of one problem: valid(i) is row i's own entry, suppressed(i, kept)
// whether a kept entry suppresses it. kept and next are [align16(c)] bytes of
// shared memory; the result is left in kept.
template <typename Valid, typename Suppressed>
__device__ void sweep_to_fixpoint(uint8_t* kept, uint8_t* next, int c, Valid valid,
                                  Suppressed suppressed) {
  __shared__ int changed;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < c; i += THREADS) kept[i] = valid(i);
  // at most c + 1 sweeps: each one fixes at least the next entry in rank order
  for (int sweep = 0; sweep <= c; ++sweep) {
    if (threadIdx.x == 0) changed = 0;
    __syncthreads();
    for (int i = warp; i < c; i += WARPS) {
      bool v = valid(i);  // the same i on every lane: the branch is warp-uniform
      if (v) v = !suppressed(i, lane);
      if (lane == 0) {
        next[i] = v;
        if (v != (kept[i] != 0)) changed = 1;
      }
    }
    __syncthreads();
    const bool again = changed != 0;
    __syncthreads();  // every thread has read `changed` before it is reset
    if (!again) break;
    for (int i = threadIdx.x; i < c; i += THREADS) kept[i] = next[i];
  }
  __syncthreads();
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    fixpoint_kernel(const uint8_t* __restrict__ sup, const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ kept_out, int c) {
  extern __shared__ uint4 smem[];
  uint8_t* kept = reinterpret_cast<uint8_t*>(smem);
  uint8_t* next = kept + align16(c);
  const long b = blockIdx.x;
  const uint8_t* rel = sup + b * c * (long)c;
  const uint8_t* vb = valid + b * c;
  sweep_to_fixpoint(
      kept, next, c, [&](int i) { return vb[i] != 0; },
      [&](int i, int lane) {
        return warp_any_hit<VEC>(rel + (long)i * c, kept, c, lane,
                                 [](int) { return true; });
      });
  for (int i = threadIdx.x; i < c; i += THREADS) kept_out[b * c + i] = kept[i];
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    classfix_kernel(const uint8_t* __restrict__ ovt, const int* __restrict__ rank,
                    const uint8_t* __restrict__ cand, uint8_t* __restrict__ kept_out,
                    int k_classes, int m) {
  extern __shared__ uint4 smem[];
  uint8_t* kept = reinterpret_cast<uint8_t*>(smem);
  uint8_t* next = kept + align16(m);
  const long bk = blockIdx.x;
  const long b = bk / k_classes;
  const uint8_t* rel = ovt + b * m * (long)m;
  const int* rk = rank + bk * m;
  const uint8_t* cb = cand + bk * m;
  sweep_to_fixpoint(
      kept, next, m, [&](int i) { return cb[i] != 0; },
      [&](int i, int lane) {
        const int ri = rk[i];
        return warp_any_hit<VEC>(rel + (long)i * m, kept, m, lane,
                                 [&](int j) { return __ldg(rk + j) < ri; });
      });
  for (int i = threadIdx.x; i < m; i += THREADS) kept_out[bk * m + i] = kept[i];
}

template <typename Kernel>
int shared_bytes_ok(Kernel kernel, long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Dynamic shared memory one block takes for a problem of c entries (bytes).
long yk_nms_smem_bytes(int c) { return 2 * align16(c); }

// fixpoint: sup [b, c, c], valid [b, c], kept [b, c], all bool (one byte).
// Returns the CUDA error code of the launch.
int yk_nms_fixpoint(const void* sup, const void* valid, void* kept, int b, int c,
                    void* stream) {
  if (b == 0 || c == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long smem = yk_nms_smem_bytes(c);
  const bool vec = c % 16 == 0 && aligned16(sup);
  auto kernel = vec ? fixpoint_kernel<true> : fixpoint_kernel<false>;
  int err = shared_bytes_ok(kernel, smem);
  if (err) return err;
  kernel<<<b, THREADS, smem, st>>>(static_cast<const uint8_t*>(sup),
                                   static_cast<const uint8_t*>(valid),
                                   static_cast<uint8_t*>(kept), c);
  return (int)cudaGetLastError();
}

// classfix: ovt [b, m, m] bool (ovt[., i, j] = box j overlaps box i), rank
// [b, k, m] i32, cand [b, k, m] bool, kept [b, k, m] bool.
int yk_nms_classfix(const void* ovt, const void* rank, const void* cand, void* kept,
                    int b, int k, int m, void* stream) {
  if (b == 0 || k == 0 || m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long smem = yk_nms_smem_bytes(m);
  const bool vec = m % 16 == 0 && aligned16(ovt);
  auto kernel = vec ? classfix_kernel<true> : classfix_kernel<false>;
  int err = shared_bytes_ok(kernel, smem);
  if (err) return err;
  kernel<<<b * k, THREADS, smem, st>>>(
      static_cast<const uint8_t*>(ovt), static_cast<const int*>(rank),
      static_cast<const uint8_t*>(cand), static_cast<uint8_t*>(kept), k, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
