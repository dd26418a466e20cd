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
// and 96 written.  Design: one thread per point with u, u^2, u^3 and the
// accumulator in registers, on the carry-chain core fq_cc.cuh (the squarings
// run as full products, so the kernel can reach at most ~84% of the bound).
// The 190 digits (MSB first) and b sit in __constant__ memory: every thread
// of a warp reads the same digit in the same step, which the constant cache
// broadcasts, and a zero digit skips its multiply for the whole warp.
#include <cuda_runtime.h>

#include "g1_sqrt.cuh"

// ptxas takes 86 registers and spills nothing with any cap of 2 to 5 blocks
// of 128 an SM, and the times agree; at 6 it spills (PERF.md)
constexpr int SQRT_THREADS = 128;
constexpr int SQRT_MIN_BLOCKS = 4;

__global__ void __launch_bounds__(SQRT_THREADS, SQRT_MIN_BLOCKS)
g1_sqrt_kernel(const uint32_t* __restrict__ pxp, int64_t n,
               uint32_t* __restrict__ oy) {
  const int64_t lane = (int64_t)blockIdx.x * SQRT_THREADS + threadIdx.x;
  if (lane >= n) return;
  cc::store16(oy, n, lane, cc::sqrt_candidate(cc::load_pairs(pxp, n, lane)));
}

extern "C" int cp_g1_sqrt(const void* pxp, int64_t n, void* oy, void* stream) {
  g1_sqrt_kernel<<<(unsigned)((n + SQRT_THREADS - 1) / SQRT_THREADS),
                   SQRT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pxp, n, (uint32_t*)oy);
  return (int)cudaGetLastError();
}
