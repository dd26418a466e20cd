// g1_suffix_weighted: the inner step of Pippenger bucket reduction.  Per
// lane, over a chunk of Cb buckets P_0..P_{Cb-1} taken from the highest
// bucket down, compute total = sum_j P_j and weighted = sum_j (j+1) * P_j.
//
// Replaces the TPU kernel `g1_suffix_weighted_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:505, body `_g1_suffix_weighted_kernel` :476).
//
// Bound: integer multiplies.  2 Cb complete adds (24 Cb field products,
// 7200 Cb 32-bit multiplies) per lane against Cb x 288 bytes read and
// 576 written.  Two entries, both on the carry-chain core fq_cc.cuh:
// - the chain (g1_suffix_weighted_kernel): one thread per lane runs the TPU
//   kernel's 2 Cb dependent adds (cc::suffix_weighted_lane), so its sums
//   are the plain version's representatives.  It serves wide launches (the
//   c = 16 reduction's 32,768 lanes fill the card);
// - the tree (g1_suffix_tree_kernel): Cb threads of one warp per lane, for
//   narrow launches (the c = 8 reduction's 512 lanes are 4 blocks of the
//   chain for 132 SMs, each thread a latency-bound chain of 16 adds).
//   Thread j holds P_j; a Hillis-Steele suffix scan in log2 Cb rounds of
//   shuffles leaves S_j = sum_{k>=j} P_k (total = S_0), then a tree sum in
//   log2 Cb rounds gives weighted = sum_j S_j.  A depth of 2 log2 Cb adds
//   instead of 2 Cb, for 2 Cb log2 Cb adds a lane instead of 2 Cb.  Its
//   order of adds differs from the chain's: its sums are the projective
//   representatives of `g1_suffix_weighted_tree_plain` (ops/kernels.py).
#include <cuda_runtime.h>

#include "g1_suffix_weighted.cuh"

// two blocks of 128 an SM, as g1_add.cu (PERF.md has each entry's ptxas)
constexpr int SUF_THREADS = 128;
constexpr int SUF_MIN_BLOCKS = 2;

__global__ void __launch_bounds__(SUF_THREADS, SUF_MIN_BLOCKS)
g1_suffix_weighted_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ y,
                          const uint32_t* __restrict__ z, int cb, int64_t wg,
                          uint32_t* __restrict__ tx, uint32_t* __restrict__ ty,
                          uint32_t* __restrict__ tz, uint32_t* __restrict__ wx,
                          uint32_t* __restrict__ wy, uint32_t* __restrict__ wz) {
  const int64_t lane = (int64_t)blockIdx.x * SUF_THREADS + threadIdx.x;
  if (lane >= wg) return;
  cc::Proj total, weighted;
  cc::suffix_weighted_lane(x, y, z, cb, wg, lane, total, weighted);
  cc::store16(tx, wg, lane, total.x);
  cc::store16(ty, wg, lane, total.y);
  cc::store16(tz, wg, lane, total.z);
  cc::store16(wx, wg, lane, weighted.x);
  cc::store16(wy, wg, lane, weighted.y);
  cc::store16(wz, wg, lane, weighted.z);
}

// the point of the thread `s` places up within its CB-wide segment (its own
// where that falls past the segment)
template <int CB>
__device__ __forceinline__ cc::Fq shfl_down(const cc::Fq& a, int s) {
  cc::Fq r;
#pragma unroll
  for (int i = 0; i < cc::NL; ++i)
    r.v[i] = __shfl_down_sync(0xffffffffu, a.v[i], s, CB);
  return r;
}

// One lane per CB threads of a warp; threads past the last lane run the
// rounds on infinity (every thread of the warp takes part in the shuffles)
// and store nothing.  One round loop, scan rounds then tree rounds, so the
// add is inlined once.
template <int CB>
__global__ void __launch_bounds__(SUF_THREADS, SUF_MIN_BLOCKS)
g1_suffix_tree_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ y,
                      const uint32_t* __restrict__ z, int64_t wg,
                      uint32_t* __restrict__ tx, uint32_t* __restrict__ ty,
                      uint32_t* __restrict__ tz, uint32_t* __restrict__ wx,
                      uint32_t* __restrict__ wy, uint32_t* __restrict__ wz) {
  constexpr int LOG = CB == 8 ? 3 : 4;
  static_assert(CB == 8 || CB == 16, "the tree entry serves Cb = 8 and 16");
  const int64_t t = (int64_t)blockIdx.x * SUF_THREADS + threadIdx.x;
  const int64_t lane = t / CB;
  const int j = (int)(t % CB);
  const bool live = lane < wg;
  const int64_t stride = (int64_t)CB * wg;
  cc::Proj v = cc::proj_infinity();
  if (live) {
    const int64_t col = (int64_t)j * wg + lane;
    v = cc::Proj{cc::load16(x, stride, col), cc::load16(y, stride, col),
                 cc::load16(z, stride, col)};
  }
#pragma unroll 1
  for (int r = 0; r < 2 * LOG; ++r) {
    if (r == LOG && j == 0 && live) {  // the scan is done: S_0 is the total
      cc::store16(tx, wg, lane, v.x);
      cc::store16(ty, wg, lane, v.y);
      cc::store16(tz, wg, lane, v.z);
    }
    const int s = 1 << (r < LOG ? r : r - LOG);
    const cc::Proj o{shfl_down<CB>(v.x, s), shfl_down<CB>(v.y, s),
                     shfl_down<CB>(v.z, s)};
    const cc::Proj sum = cc::g1_add(v, o);
    // scan rounds keep S_j where j + s is past the chunk; in tree rounds
    // only the threads j = 0 mod 2s matter, and they always take the sum
    const bool take = r >= LOG || j + s < CB;
#pragma unroll
    for (int i = 0; i < cc::NL; ++i) {
      v.x.v[i] = take ? sum.x.v[i] : v.x.v[i];
      v.y.v[i] = take ? sum.y.v[i] : v.y.v[i];
      v.z.v[i] = take ? sum.z.v[i] : v.z.v[i];
    }
  }
  if (j == 0 && live) {
    cc::store16(wx, wg, lane, v.x);
    cc::store16(wy, wg, lane, v.y);
    cc::store16(wz, wg, lane, v.z);
  }
}

extern "C" int cp_g1_suffix_weighted(const void* x, const void* y, const void* z,
                                     int cb, int64_t wg, void* tx, void* ty,
                                     void* tz, void* wx, void* wy, void* wz,
                                     void* stream) {
  g1_suffix_weighted_kernel<<<(unsigned)((wg + SUF_THREADS - 1) / SUF_THREADS),
                              SUF_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, cb, wg,
      (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, (uint32_t*)wx, (uint32_t*)wy,
      (uint32_t*)wz);
  return (int)cudaGetLastError();
}

extern "C" int cp_g1_suffix_weighted_tree(const void* x, const void* y,
                                          const void* z, int cb, int64_t wg,
                                          void* tx, void* ty, void* tz,
                                          void* wx, void* wy, void* wz,
                                          void* stream) {
  const unsigned blocks =
      (unsigned)((wg * cb + SUF_THREADS - 1) / SUF_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *ux = (const uint32_t*)x, *uy = (const uint32_t*)y,
                 *uz = (const uint32_t*)z;
  uint32_t *otx = (uint32_t*)tx, *oty = (uint32_t*)ty, *otz = (uint32_t*)tz,
           *owx = (uint32_t*)wx, *owy = (uint32_t*)wy, *owz = (uint32_t*)wz;
  if (cb == 8)
    g1_suffix_tree_kernel<8><<<blocks, SUF_THREADS, 0, st>>>(
        ux, uy, uz, wg, otx, oty, otz, owx, owy, owz);
  else if (cb == 16)
    g1_suffix_tree_kernel<16><<<blocks, SUF_THREADS, 0, st>>>(
        ux, uy, uz, wg, otx, oty, otz, owx, owy, owz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
