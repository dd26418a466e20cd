// g1_add: batched complete projective addition on BLS12-381 G1 (RCB16
// algorithm 7, a = 0), and one round of the masked suffix scans built on it.
//
// Replaces the TPU kernel `g1_add_pallas_flat` (curdleproofs_tpu/ops/
// pallas_kernels.py:282, launched by `_g1_add_pallas_padded` :311, body
// `_g1_add_kernel` :254 -> `_k_g1_add` :90).  The TPU wrapper pads the batch
// to its 512-lane granule; here any width launches as it is.  The second
// entry, g1_add_scan_kernel, is that kernel with its caller's gather and
// select folded in (the slot merge and the suffix over chunks of the bucket
// reduction, curdleproofs_tpu/ops/msm_device.py:506-515 and :567-579).
//
// Bound: integer multiplies.  12 field products = 7200 32-bit multiplies a
// lane against 6 x 96 bytes read and 3 x 96 written.  Design: one thread per
// lane, both points and every temporary in registers, coalesced loads of the
// [24, N] limb rows; the field core is fq_cc.cuh (carry chains, one wide
// multiply-add a 32x32 product), as in the bucket fold.
#include <cuda_runtime.h>

#include "fq_cc.cuh"

// two blocks of 128 an SM: ptxas takes 210 registers (214 in the scan entry)
// and spills nothing.  Three blocks fit 168 registers with 16 bytes of spill
// (48 in the scan entry): faster at 1,835,520 lanes, slower at 2^16.  Blocks
// of 64 or 32 threads were no faster at 512 and 32,768 lanes (PERF.md).
constexpr int ADD_THREADS = 128;
constexpr int ADD_MIN_BLOCKS = 2;

__global__ void __launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS)
g1_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
              uint32_t* __restrict__ oz, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (lane >= n) return;
  const cc::Proj p{cc::load16(x1, n, lane), cc::load16(y1, n, lane),
                   cc::load16(z1, n, lane)};
  const cc::Proj q{cc::load16(x2, n, lane), cc::load16(y2, n, lane),
                   cc::load16(z2, n, lane)};
  const cc::Proj r = cc::g1_add(p, q);
  cc::store16(ox, n, lane, r.x);
  cc::store16(oy, n, lane, r.y);
  cc::store16(oz, n, lane, r.z);
}

// One Hillis-Steele round over [24, n] points v, out of place:
//   out[i] = v[i] + v[i + stride]  where i + stride < n and key[i + stride]
//            == key[i],  else v[i],
// so every lane reads the previous round's points.  A warp whose lanes all
// keep their point does no arithmetic.
__global__ void __launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS)
g1_add_scan_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ z,
                   const int64_t* __restrict__ key, int64_t stride, int64_t n,
                   uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz) {
  const int64_t lane = (int64_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (lane >= n) return;
  const int64_t j = lane + stride;
  cc::Proj r{cc::load16(x, n, lane), cc::load16(y, n, lane),
             cc::load16(z, n, lane)};
  if (j < n && key[j] == key[lane]) {
    const cc::Proj q{cc::load16(x, n, j), cc::load16(y, n, j),
                     cc::load16(z, n, j)};
    r = cc::g1_add(r, q);
  }
  cc::store16(ox, n, lane, r.x);
  cc::store16(oy, n, lane, r.y);
  cc::store16(oz, n, lane, r.z);
}

static unsigned blocks_for(int64_t n) {
  return (unsigned)((n + ADD_THREADS - 1) / ADD_THREADS);
}

extern "C" int cp_g1_add(const void* x1, const void* y1, const void* z1,
                         const void* x2, const void* y2, const void* z2,
                         void* ox, void* oy, void* oz, int64_t n, void* stream) {
  g1_add_kernel<<<blocks_for(n), ADD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int cp_g1_add_scan(const void* x, const void* y, const void* z,
                              const void* key, int64_t stride, int64_t n,
                              void* ox, void* oy, void* oz, void* stream) {
  g1_add_scan_kernel<<<blocks_for(n), ADD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (const int64_t*)key, stride, n, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz);
  return (int)cudaGetLastError();
}
