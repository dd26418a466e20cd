// g1_fold_rows: fold pre-gathered projective rows with the complete add.
// x, y, z are [24, T, S] 16-bit limb rows of points with a general z; column
// s starts at infinity (0 : 1 : 0) and adds rows t = 0..T-1 in order, every
// row, z = 0 rows too.
//
// Replaces the TPU kernel `g1_fold_rows_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:453, body `_g1_fold_rows_kernel` :327 -> `_k_g1_add`
// :90).  On the TPU the (S/512, T/8) grid carries the accumulator in the
// resident output block; here each thread loops over all T rows with the
// accumulator in registers (`cc::fold_rows_lane`, g1_fold_rows.cuh).  The
// TPU kernel asks for S a multiple of 512 and T a multiple of 8; this one
// takes any T >= 1 and S >= 1 and masks the ragged edge.  The complete add
// does not keep P's representative for P + infinity, so dead rows are added
// like live ones, as on the TPU, and the output equals the plain version's.
//
// Bound: integer multiplies.  T complete adds of 12 field products (7200
// 32-bit multiplies each) a column against 3 x 96 bytes read a row.
// Design: one thread a column (the lane is the column, so a warp's loads of
// a limb row coalesce), both points and every temporary in registers, the
// carry-chain core fq_cc.cuh with each product inlined, as g1_add.cu.
#include <cuda_runtime.h>

#include "g1_fold_rows.cuh"

// two blocks of 128 an SM, as g1_add.cu
constexpr int ROWS_THREADS = 128;
constexpr int ROWS_MIN_BLOCKS = 2;

__global__ void __launch_bounds__(ROWS_THREADS, ROWS_MIN_BLOCKS)
g1_fold_rows_kernel(const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ z, int t_rows, int64_t s,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz) {
  const int64_t lane = (int64_t)blockIdx.x * ROWS_THREADS + threadIdx.x;
  if (lane >= s) return;
  const cc::Proj acc = cc::fold_rows_lane(x, y, z, t_rows, s, lane);
  cc::store16(ox, s, lane, acc.x);
  cc::store16(oy, s, lane, acc.y);
  cc::store16(oz, s, lane, acc.z);
}

extern "C" int cp_g1_fold_rows(const void* x, const void* y, const void* z,
                               int t_rows, int64_t s, void* ox, void* oy,
                               void* oz, void* stream) {
  g1_fold_rows_kernel<<<(unsigned)((s + ROWS_THREADS - 1) / ROWS_THREADS),
                        ROWS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, t_rows, s,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}
