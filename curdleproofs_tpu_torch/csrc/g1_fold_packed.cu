// g1_fold_packed: the Pippenger bucket fold with the 12-multiply complete add.
// For each slot s, accumulate the T resident bases that the plan assigns to
// it, z rebuilt from the liveness bit (Montgomery one, or 0).
//
// Replaces the TPU kernel `g1_fold_rows_packed_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:439, launch `_fold_packed_call` :420, body
// `_g1_fold_rows_packed_kernel` :381 -> `_k_g1_add` :115), the fold that the
// reference's `CURDLEPROOFS_MADD=0` switch selects.  Same interface and design
// as g1_fold_madd.cu: one thread per slot loops over all T rows with the
// accumulator in registers and gathers from the resident [P | -P | inf]
// arrays itself.  Unlike the mixed-add fold, every row goes through the add,
// dead rows too (z = 0), as the TPU kernel does: the complete add returns the
// same point for P + infinity but not the same projective representative, so
// skipping them would change the output.
//
// Bound: integer multiplies.  T complete adds of 12 field products (3600
// 32x32->64 multiplies each) per slot against 100 bytes gathered per row.
#include <cuda_runtime.h>

#include "bls12_381.cuh"

__global__ void __launch_bounds__(128)
g1_fold_packed_kernel(const uint32_t* __restrict__ ext_px,
                      const uint32_t* __restrict__ ext_py,
                      const uint32_t* __restrict__ ext_zb,
                      const int32_t* __restrict__ plan, int64_t n_ext, int t_rows,
                      int64_t s_pad, uint32_t* __restrict__ ox,
                      uint32_t* __restrict__ oy, uint32_t* __restrict__ oz) {
  int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_pad) return;
  cp::Proj acc = cp::proj_infinity();
  for (int t = 0; t < t_rows; ++t) {
    int64_t e = plan[(int64_t)t * s_pad + s];
    cp::Proj q{cp::load_pairs(ext_px, n_ext, e), cp::load_pairs(ext_py, n_ext, e),
               ext_zb[e] != 0 ? cp::fq_one_mont() : cp::fq_zero()};
    acc = cp::g1_add(acc, q);
  }
  cp::store_point16(ox, oy, oz, s_pad, s, acc);
}

extern "C" int cp_g1_fold_packed(const void* ext_px, const void* ext_py,
                                 const void* ext_zb, const void* plan,
                                 int64_t n_ext, int t_rows, int64_t s_pad,
                                 void* ox, void* oy, void* oz, void* stream) {
  const int threads = 128;
  g1_fold_packed_kernel<<<(unsigned)((s_pad + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)ext_px, (const uint32_t*)ext_py, (const uint32_t*)ext_zb,
      (const int32_t*)plan, n_ext, t_rows, s_pad, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz);
  return (int)cudaGetLastError();
}
