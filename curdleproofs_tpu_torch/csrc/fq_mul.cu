// fq_mul: batched Montgomery product a * b * 2^-384 mod q.
//
// Replaces the TPU kernel `fq_mul_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:268, body `_fq_mul_kernel` :246).
//
// Bound: bytes at the widths the MSM path launches.  One product is 300
// 32x32->64 products (600 32-bit multiplies) against 2 x 96 bytes read and
// 96 written: about 2 multiplies a byte (3 with a broadcast operand), under
// the card's balance of about 5 (16.7 T multiplies/s over 3.35 TB/s), so
// device memory, not the multiplier, sets the floor.  Design: one thread per lane on the carry-chain core fq_cc.cuh
// (cc::fq_mul, the product of the fold and the adds), loads and stores of
// the [24, N] limb rows coalesced across the warp.  An operand of one column
// (the plain 1 of leave-Montgomery and of the ingest's parity product) is
// read by every lane from that column, so the wrapper never materialises
// its broadcast.
#include <cuda_runtime.h>

#include "fq_cc.cuh"

constexpr int MUL_THREADS = 128;

// a: [24, a_cols], b: [24, b_cols], each of n columns or of 1 (broadcast)
__global__ void __launch_bounds__(MUL_THREADS)
fq_mul_kernel(const uint32_t* __restrict__ a, int64_t a_cols,
              const uint32_t* __restrict__ b, int64_t b_cols,
              uint32_t* __restrict__ out, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * MUL_THREADS + threadIdx.x;
  if (lane >= n) return;
  const cc::Fq x = cc::load16(a, a_cols, a_cols == 1 ? 0 : lane);
  const cc::Fq y = cc::load16(b, b_cols, b_cols == 1 ? 0 : lane);
  cc::store16(out, n, lane, cc::fq_mul(x, y));
}

extern "C" int cp_fq_mul(const void* a, int64_t a_cols, const void* b,
                         int64_t b_cols, void* out, int64_t n, void* stream) {
  fq_mul_kernel<<<(unsigned)((n + MUL_THREADS - 1) / MUL_THREADS), MUL_THREADS,
                  0, (cudaStream_t)stream>>>((const uint32_t*)a, a_cols,
                                             (const uint32_t*)b, b_cols,
                                             (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
