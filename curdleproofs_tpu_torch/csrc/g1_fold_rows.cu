// g1_fold_rows: fold pre-gathered projective rows with the complete add.
// x, y, z are [24, T, S] 16-bit limb rows of points with a general z; column
// s starts at infinity (0 : 1 : 0) and adds rows t = 0..T-1 in order, every
// row, z = 0 rows too.
//
// Replaces the TPU kernel `g1_fold_rows_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:453, body `_g1_fold_rows_kernel` :327 -> `_k_g1_add`
// :90).  On the TPU the (S/512, T/8) grid carries the accumulator in the
// resident output block; here each thread loops over all T rows with the
// accumulator in registers.  The TPU kernel asks for S a multiple of 512 and
// T a multiple of 8; this one takes any T >= 1 and S >= 1 and masks the
// ragged edge.  The complete add does not keep P's representative for
// P + infinity, so dead rows are added like live ones, as on the TPU, and the
// output equals the plain version's.
//
// Bound: integer multiplies.  T complete adds of 12 field products (7200
// 32-bit multiplies each) per column against 3 x 96 bytes read per row.
// Design: the shape of g1_fold_packed.cu, loading [24, T, S] rows, coalesced
// across the warp (lane = column), instead of gathering resident bases.
#include <cuda_runtime.h>

#include "bls12_381.cuh"

__global__ void __launch_bounds__(128)
g1_fold_rows_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ z, int t_rows, int64_t s,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= s) return;
  const int64_t stride = (int64_t)t_rows * s;  // between limb rows
  cp::Proj acc = cp::proj_infinity();
  for (int t = 0; t < t_rows; ++t) {
    const int64_t off = (int64_t)t * s;
    acc = cp::g1_add(acc,
                     cp::load_point16(x + off, y + off, z + off, stride, lane));
  }
  cp::store_point16(ox, oy, oz, s, lane, acc);
}

extern "C" int cp_g1_fold_rows(const void* x, const void* y, const void* z,
                               int t_rows, int64_t s, void* ox, void* oy, void* oz,
                               void* stream) {
  const int threads = 128;
  g1_fold_rows_kernel<<<(unsigned)((s + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, t_rows, s,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}
