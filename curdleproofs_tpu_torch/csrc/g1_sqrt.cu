// g1_sqrt: the y-candidate of compressed base ingest, y = (x^3 + b)^((q+1)/4).
//
// Replaces the TPU kernel `g1_sqrt_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:201, launch `_g1_sqrt_call` :215, body `_g1_sqrt_kernel`
// :187, chain `_k_sqrt_candidate` :158).  The caller fixes the sign from the
// parity bit and forces dead lanes to the identity (ops/msm_device.py).
//
// Bound: integer multiplies.  The function needs 380 squarings (234
// 32x32->64 products each) and 158 multiplies (300 each) a point: x^2, x^3,
// u^2 and u^3, then after the first nonzero digit (which loads u^d) two
// squarings a digit and a multiply a nonzero digit; against 48 bytes read
// and 96 written.
//
// Two entries, both hand-written; the wrapper picks one by width
// (`kernels.sqrt_uses_pair`):
// - g1_sqrt_kernel, wide launches (the 626k MSM's 655,360 bases): one
//   thread per point with u, u^2, u^3 and the accumulator in registers
//   (cc::sqrt_candidate; the squarings run as full products, so the kernel
//   can reach at most ~84% of the bound).  The 190 digits (MSB first) and
//   b sit in __constant__ memory: every thread of a warp reads the same
//   digit in the same step, which the constant cache broadcasts, and a zero
//   digit skips its multiply for the whole warp.
// - g1_sqrt_pair_kernel, narrow launches (a protocol MSM's 64-768 fresh
//   bases): there the card is nearly empty and what sets the time is a
//   point's chain of dependent products (~0.9 us each: a product's carry
//   chains are ordered, so a lane has one in flight).  A pair of lanes a
//   point runs the right-to-left binary method (cc::sqrt_pair): each step
//   one lane squares and the other multiplies, and both lanes read the
//   two products by shuffles, so the chain is 381 products where the
//   one-thread chain is 538, at ~1.4x the products.
#include <cuda_runtime.h>

#include "g1_sqrt.cuh"

// ptxas takes 86 registers and spills nothing with any cap of 2 to 5 blocks
// of 128 an SM, and the times agree; at 6 it spills (PERF.md)
constexpr int SQRT_THREADS = 128;
constexpr int SQRT_MIN_BLOCKS = 4;
constexpr int PAIR_THREADS = 128;  // 64 points a block

__global__ void __launch_bounds__(SQRT_THREADS, SQRT_MIN_BLOCKS)
g1_sqrt_kernel(const uint32_t* __restrict__ pxp, int64_t n,
               uint32_t* __restrict__ oy) {
  const int64_t lane = (int64_t)blockIdx.x * SQRT_THREADS + threadIdx.x;
  if (lane >= n) return;
  cc::store16(oy, n, lane, cc::sqrt_candidate(cc::load_pairs(pxp, n, lane)));
}

// Lanes 2p and 2p + 1 run point p.  A pair past the last point runs the
// last one again (its warp's shuffles need it) and stores nothing.
__global__ void __launch_bounds__(PAIR_THREADS)
g1_sqrt_pair_kernel(const uint32_t* __restrict__ pxp, int64_t n,
                    uint32_t* __restrict__ oy) {
  const int64_t t = (int64_t)blockIdx.x * PAIR_THREADS + threadIdx.x;
  if ((t & ~(int64_t)31) / 2 >= n) return;  // the whole warp lies past n
  const int64_t pt = t / 2;
  const int role = (int)(t & 1);
  cc::ShuffleExchange<2> ex{role, {}};
  const cc::Fq y =
      cc::sqrt_pair(ex, cc::load_pairs(pxp, n, pt < n ? pt : n - 1));
  if (pt < n && role == 0) cc::store16(oy, n, pt, y);
}

extern "C" int cp_g1_sqrt(const void* pxp, int64_t n, void* oy, void* stream) {
  g1_sqrt_kernel<<<(unsigned)((n + SQRT_THREADS - 1) / SQRT_THREADS),
                   SQRT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pxp, n, (uint32_t*)oy);
  return (int)cudaGetLastError();
}

extern "C" int cp_g1_sqrt_pair(const void* pxp, int64_t n, void* oy,
                               void* stream) {
  g1_sqrt_pair_kernel<<<(unsigned)((2 * n + PAIR_THREADS - 1) / PAIR_THREADS),
                        PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pxp, n, (uint32_t*)oy);
  return (int)cudaGetLastError();
}
