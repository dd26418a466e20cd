// g1_sqrt: the y-candidate of compressed base ingest, y = (x^3 + b)^((q+1)/4).
//
// Replaces the TPU kernel `g1_sqrt_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:201, launch `_g1_sqrt_call` :215, body `_g1_sqrt_kernel`
// :187, chain `_k_sqrt_candidate` :158).  The caller fixes the sign from the
// parity bit and forces dead lanes to the identity (ops/msm_device.py).
//
// Bound: integer multiplies.  The kernel runs 574 Montgomery products per
// point (2 for x^3, 2 for u^2 and u^3, then 190 two-bit digits of 2
// squarings and 1 table multiply each); the function needs 380 squarings
// (234 32x32->64 products each) and 158 multiplies (300 each), since the
// squarings of the initial one and the multiplies by one on zero digits are
// identities.  That is against 48 bytes read and 96 written.  Design: one thread per point with u, u^2, u^3 and the
// accumulator in registers.  The 190 digits (MSB first), b and Montgomery one
// sit in __constant__ memory: every thread of a warp reads the same digit in
// the same step, which the constant cache broadcasts.  Digit 0 multiplies by
// Montgomery one, as the TPU kernel does, so the chain is branch-free in the
// data and its residues equal the plain version's step for step.
#include <cuda_runtime.h>

#include "g1_sqrt.cuh"

__global__ void __launch_bounds__(128)
g1_sqrt_kernel(const uint32_t* __restrict__ pxp, int64_t n,
               uint32_t* __restrict__ oy) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  cp::Fq y = cp::sqrt_candidate(cp::load_pairs(pxp, n, lane));
  cp::store_rows16(oy, n, lane, y);
}

extern "C" int cp_g1_sqrt(const void* pxp, int64_t n, void* oy, void* stream) {
  const int threads = 128;
  g1_sqrt_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>((const uint32_t*)pxp, n, (uint32_t*)oy);
  return (int)cudaGetLastError();
}
