// g1_horner: the grouped MSM's Horner step in one launch, the window sums of
// every relation of a dispatch to its canonical point.
//
// Replaces the JAX package's `horner_device` (curdleproofs_tpu/ops/
// msm_grouped.py:255): a `lax.fori_loop` of 64 steps inside the grouped
// jits, each 4 complete self-adds and 1 complete add through the Pallas
// `g1_add_pallas_flat`, then leave-Montgomery, all one device program.  The
// port ran it as 320 g1_add launches and one fq_mul a dispatch.
//
// Bound: integer multiplies, n_rel x 320 complete adds x 12 products, plus
// 3 products a relation to leave Montgomery form (at 1536 relations about
// 0.2 ms of the card's integer rate); bytes are 3 x 96 x 64 in and 3 x 48
// out a relation.  The chain is what sets the time: a relation's 3,843
// products depend one on the next, and at ~1.1 us a product for one warp on
// a scheduler (the ladder's, PERF.md) that is ~4-5 ms however many
// relations run beside it, until the card fills (~16k relations).
//
// Design: one thread a relation, the accumulator in registers for all 64
// windows, each step on the carry-chain core (cc::g1_add), in the
// reference's order, so the words are the reference's.  The [24, n_rel, 64]
// window sums are relation-major (a relation's 64 sums of a limb row are
// contiguous), so a lane reading its own relation strides 256 bytes from
// its neighbour's.  Each warp therefore stages 8 windows at a time through
// shared memory: one load instruction reads 4 relations x 8 windows, four
// whole 32-byte sectors, and a lane then reads its relation's words from
// shared memory (padded so that neither side conflicts on a bank).  The
// three coordinates leave Montgomery form before the store.  A block is 128
// threads (a warp's stage is 36,992 bytes, a block's 147,968): of 32, 64
// and 128, timed in turns on an H100 at 96 and 1536 relations, none
// spilled and 128 was the fastest, by 0.1-2.4% (PERF.md).  The chain's
// adds and leave-Montgomery's products each go through one call site, so
// nvcc inlines the complete add and the product once.
#include <cuda_runtime.h>

#include "g1_horner.cuh"

namespace {

constexpr int HORNER_THREADS = 128;
constexpr int CHUNK = 8;      // windows staged at once: a sector of a row
constexpr int WORDS = 36;     // x, y, z: 12 words each
constexpr int WIN_STRIDE = WORDS * 32 + 4;  // one window of a warp, padded
constexpr int WARP_STAGE = CHUNK * WIN_STRIDE;  // words

CC_HD uint32_t ldg(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

CC_HD void syncwarp() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// The window sums of a warp's 32 relations, staged 8 windows at a time.
// Every lane of the warp calls it with the same w, from 63 down.  (Its
// methods are host-device, as cc::horner is, with the warp's intrinsics in
// the device pass alone; only the kernel calls them.)
struct StagedWindows {
  const uint32_t *x, *y, *z;
  int64_t n_rel, rel0;  // rel0: the warp's first relation
  uint32_t* st;         // the warp's stage
  int lane;

  CC_HD void stage(int w0) {
    const int win = lane & (CHUNK - 1), sub = lane >> 3;
    const int64_t stride = n_rel * cc::HORNER_WINDOWS;
    const uint32_t* rows[3] = {x, y, z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll 1
      for (int i = 0; i < cc::NL; ++i) {
#pragma unroll
        for (int k = 0; k < 32 / 4; ++k) {
          const int rl = 4 * k + sub;
          const int64_t rel = rel0 + rl < n_rel ? rel0 + rl : n_rel - 1;
          const uint32_t* p =
              rows[c] + 2 * i * stride + rel * cc::HORNER_WINDOWS + w0 + win;
          st[win * WIN_STRIDE + (c * cc::NL + i) * 32 + rl] =
              ldg(p) | (ldg(p + stride) << 16);
        }
      }
    }
  }

  CC_HD cc::Proj operator()(int w) {
    if ((w & (CHUNK - 1)) == CHUNK - 1) {
      syncwarp();  // the warp has read the last chunk
      stage(w - (CHUNK - 1));
      syncwarp();
    }
    const uint32_t* s = st + (w & (CHUNK - 1)) * WIN_STRIDE + lane;
    cc::Proj p;
#pragma unroll
    for (int i = 0; i < cc::NL; ++i) {
      p.x.v[i] = s[i * 32];
      p.y.v[i] = s[(cc::NL + i) * 32];
      p.z.v[i] = s[(2 * cc::NL + i) * 32];
    }
    return p;
  }
};

__global__ void __launch_bounds__(HORNER_THREADS)
g1_horner_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ z, uint32_t* __restrict__ out,
                 int64_t n_rel) {
  extern __shared__ uint32_t stage[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t rel0 = (int64_t)blockIdx.x * HORNER_THREADS + warp * 32;
  if (rel0 >= n_rel) return;  // the whole warp lies past the last relation
  StagedWindows win{x, y, z, n_rel, rel0, stage + warp * WARP_STAGE, lane};
  const cc::Proj acc = cc::horner(win);
  if (rel0 + lane < n_rel) cc::store_canonical(out, n_rel, rel0 + lane, acc);
}

}  // namespace

// x, y, z: [24, n_rel, 64] Montgomery window sums; out: [3, 24, n_rel]
// canonical points
extern "C" int cp_g1_horner(const void* x, const void* y, const void* z,
                            void* out, int64_t n_rel, void* stream) {
  constexpr int smem = HORNER_THREADS / 32 * WARP_STAGE * sizeof(uint32_t);
  // above the default 48 KiB: ask for it
  const cudaError_t e = cudaFuncSetAttribute(
      g1_horner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks =
      (unsigned)((n_rel + HORNER_THREADS - 1) / HORNER_THREADS);
  g1_horner_kernel<<<blocks, HORNER_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)out, n_rel);
  return (int)cudaGetLastError();
}
