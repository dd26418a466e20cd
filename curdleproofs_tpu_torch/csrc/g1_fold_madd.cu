// g1_fold_madd: the Pippenger bucket fold.  For each slot s, accumulate the
// T resident bases that the plan assigns to it with the complete mixed add.
//
// Replaces the TPU kernel `g1_fold_rows_madd_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:446, launch `_fold_packed_call` :420, body
// `_g1_fold_rows_madd_kernel` :398 -> `_k_g1_madd` :115).  On the TPU the
// (S/512, T/8) grid carries the accumulator from one grid step to the next;
// no block carries anything to another here, so each thread loops over all T
// rows with the accumulator in registers, visiting them in plan order
// (t = 0..T-1) so that each slot's sum, projective representative included,
// equals the plain version's.  Dead rows (liveness bit 0: input infinities
// and the plan's sentinel) keep the accumulator.  The TPU caller
// materialises the gathered bases ([12, T, S] twice); this kernel gathers
// from the resident [P | -P | inf] bases itself.
//
// Bound: integer multiplies.  Each live row is one mixed add of 11 field
// products (6600 32-bit multiplies) against 100 bytes gathered.  The design
// follows what the first version lost on the 626k plan (PERF.md):
// - arithmetic: the field core is fq_cc.cuh, whose Montgomery product runs
//   on carry chains, one wide multiply-add per 32x32 product, instead of the
//   64-bit C of bls12_381.cuh;
// - gathers: the resident layout keeps each limb in its own row ([12, E]),
//   so one base touched 24 sectors of 32 bytes for its 96 bytes, and the
//   gathers cost about as much as the arithmetic without overlapping it.
//   The launch first repacks the bases point-major into scratch ([E, 24]:
//   x then y, 96 contiguous bytes, three sectors), a pass over 2 x 48 E
//   bytes, and the fold reads each live row as six 16-byte loads;
// - registers: the product is inlined (out of line it ran slower) and
//   `__launch_bounds__(FOLD_THREADS, FOLD_MIN_BLOCKS)` sets the cap.
#include <cuda_runtime.h>

#include "fq_cc.cuh"

constexpr int FOLD_THREADS = 128;
// two blocks an SM: ptxas then takes 188 registers and spills nothing (at
// three it fits 154, at four 128 with spills; both ran slower on the 626k
// plan, PERF.md)
constexpr int FOLD_MIN_BLOCKS = 2;
constexpr int REPACK_THREADS = 256;

// [12, E] packed limb pairs of x and of y -> [E, 24] (x words, then y)
__global__ void __launch_bounds__(REPACK_THREADS)
g1_fold_repack_kernel(const uint32_t* __restrict__ ext_px,
                      const uint32_t* __restrict__ ext_py, int64_t n_ext,
                      uint4* __restrict__ pts) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_ext) return;
  uint32_t w[2 * cc::NL];
#pragma unroll
  for (int i = 0; i < cc::NL; ++i) {
    w[i] = __ldg(ext_px + i * n_ext + e);
    w[cc::NL + i] = __ldg(ext_py + i * n_ext + e);
  }
#pragma unroll
  for (int k = 0; k < cc::NL / 2; ++k)
    pts[e * (cc::NL / 2) + k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2],
                                           w[4 * k + 3]);
}

// column `col` of a [24, stride] array of 16-bit limbs
__device__ __forceinline__ void store_rows16(uint32_t* __restrict__ rows,
                                             int64_t stride, int64_t col,
                                             const cc::Fq& a) {
#pragma unroll
  for (int i = 0; i < cc::NL; ++i) {
    rows[(2 * i) * stride + col] = a.v[i] & 0xffffu;
    rows[(2 * i + 1) * stride + col] = a.v[i] >> 16;
  }
}

__global__ void __launch_bounds__(FOLD_THREADS, FOLD_MIN_BLOCKS)
g1_fold_madd_kernel(const uint4* __restrict__ pts,
                    const uint32_t* __restrict__ ext_zb,
                    const int32_t* __restrict__ plan, int t_rows, int64_t s_pad,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz) {
  const int64_t s = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (s >= s_pad) return;
  cc::Proj acc = cc::proj_infinity();
  for (int t = 0; t < t_rows; ++t) {
    const int64_t e = __ldg(plan + (int64_t)t * s_pad + s);
    if (__ldg(ext_zb + e) == 0) continue;
    uint32_t w[2 * cc::NL];
#pragma unroll
    for (int k = 0; k < cc::NL / 2; ++k) {
      const uint4 u = __ldg(pts + e * (cc::NL / 2) + k);
      w[4 * k] = u.x;
      w[4 * k + 1] = u.y;
      w[4 * k + 2] = u.z;
      w[4 * k + 3] = u.w;
    }
    cc::Fq x2, y2;
#pragma unroll
    for (int i = 0; i < cc::NL; ++i) {
      x2.v[i] = w[i];
      y2.v[i] = w[cc::NL + i];
    }
    acc = cc::g1_madd(acc, x2, y2);
  }
  store_rows16(ox, s_pad, s, acc.x);
  store_rows16(oy, s_pad, s, acc.y);
  store_rows16(oz, s_pad, s, acc.z);
}

// pts: scratch of n_ext x 24 words from the caller
extern "C" int cp_g1_fold_madd(const void* ext_px, const void* ext_py,
                               const void* ext_zb, const void* plan, int64_t n_ext,
                               int t_rows, int64_t s_pad, void* pts, void* ox,
                               void* oy, void* oz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  g1_fold_repack_kernel<<<(unsigned)((n_ext + REPACK_THREADS - 1) / REPACK_THREADS),
                          REPACK_THREADS, 0, st>>>(
      (const uint32_t*)ext_px, (const uint32_t*)ext_py, n_ext, (uint4*)pts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  g1_fold_madd_kernel<<<(unsigned)((s_pad + FOLD_THREADS - 1) / FOLD_THREADS),
                        FOLD_THREADS, 0, st>>>(
      (const uint4*)pts, (const uint32_t*)ext_zb, (const int32_t*)plan, t_rows,
      s_pad, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}
