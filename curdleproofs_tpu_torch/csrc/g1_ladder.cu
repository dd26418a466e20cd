// g1_ladder: the batched scalar multiplications of the all-device backend,
// 255-step double-and-add ladders on BLS12-381 G1, one thread a point.
//
// Replaces the JAX package's jitted ladders `batch_mul_jit`,
// `batch_mul_each_jit` and `fold_jit` (curdleproofs_tpu/ops/msm.py:73-75,
// bodies `batch_mul_kernel` :36, `batch_mul_each_kernel` :51, `fold_kernel`
// :66): there each call is one XLA program, a `lax.scan` of 255 steps of a
// doubling, a complete add and a select.  Three entries:
//   cp_g1_batch_mul       k * P_i, one scalar for all lanes
//   cp_g1_batch_mul_each  k_i * P_i, one scalar a lane ([8, n] words)
//   cp_g1_fold            L_i + k * R_i, one scalar (the add after the
//                         ladder, left first, as `fold_kernel`)
//
// Bound: integer multiplies.  A step is 8 field products (the doubling, two
// of them squarings) and 12 (the add); a point's 255 steps are up to 5100
// products, 2.99 million 32-bit multiplies, against 3 x 96 bytes read and
// 3 x 96 written.  Design:
// the point and the accumulator stay in registers for all 255 steps, on the
// carry-chain core fq_cc.cuh (cc::g1_double, cc::g1_add); the loads and
// stores of the [24, N] limb rows are coalesced across the warp.  The one
// scalar of the uniform entries is read by every lane from the same words.
// At the protocol's widths (124-252 points, one or two blocks) the time is
// one thread's chain of products: a lane's ladder is not split.
#include <cuda_runtime.h>

#include "g1_ladder.cuh"

constexpr int LADDER_THREADS = 128;

// words: [8] (UNIFORM) or [8, n] (a scalar a lane, word-major so that the
// warp's loads are coalesced); lx, ly, lz: the left points of the fold
template <bool UNIFORM, bool FOLD>
__global__ void __launch_bounds__(LADDER_THREADS)
g1_ladder_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ z,
                 const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ lx,
                 const uint32_t* __restrict__ ly,
                 const uint32_t* __restrict__ lz, uint32_t* __restrict__ ox,
                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * LADDER_THREADS + threadIdx.x;
  if (lane >= n) return;
  const cc::Proj r = cc::ladder_lane<UNIFORM, FOLD>(x, y, z, words, lx, ly,
                                                    lz, n, lane);
  cc::store16(ox, n, lane, r.x);
  cc::store16(oy, n, lane, r.y);
  cc::store16(oz, n, lane, r.z);
}

template <bool UNIFORM, bool FOLD>
static int launch(const void* x, const void* y, const void* z,
                  const void* words, const void* lx, const void* ly,
                  const void* lz, void* ox, void* oy, void* oz, int64_t n,
                  void* stream) {
  const unsigned blocks = (unsigned)((n + LADDER_THREADS - 1) / LADDER_THREADS);
  g1_ladder_kernel<UNIFORM, FOLD>
      <<<blocks, LADDER_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
          (const uint32_t*)words, (const uint32_t*)lx, (const uint32_t*)ly,
          (const uint32_t*)lz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int cp_g1_batch_mul(const void* x, const void* y, const void* z,
                               const void* words, void* ox, void* oy, void* oz,
                               int64_t n, void* stream) {
  return launch<true, false>(x, y, z, words, nullptr, nullptr, nullptr, ox, oy,
                             oz, n, stream);
}

extern "C" int cp_g1_batch_mul_each(const void* x, const void* y,
                                    const void* z, const void* words, void* ox,
                                    void* oy, void* oz, int64_t n,
                                    void* stream) {
  return launch<false, false>(x, y, z, words, nullptr, nullptr, nullptr, ox,
                              oy, oz, n, stream);
}

extern "C" int cp_g1_fold(const void* lx, const void* ly, const void* lz,
                          const void* x, const void* y, const void* z,
                          const void* words, void* ox, void* oy, void* oz,
                          int64_t n, void* stream) {
  return launch<true, true>(x, y, z, words, lx, ly, lz, ox, oy, oz, n,
                            stream);
}
