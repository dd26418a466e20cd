// g1_horner: the grouped MSM's Horner step in one launch, the window sums
// of every relation of a dispatch to its canonical point.
//
// Replaces the JAX package's `horner_device` (curdleproofs_tpu/ops/
// msm_grouped.py:255): a `lax.fori_loop` of 64 steps inside the grouped
// jits, each 4 complete self-adds and 1 complete add through the Pallas
// `g1_add_pallas_flat`, then leave-Montgomery, all one device program.
//
// Bound: integer multiplies, n_rel x (256 doublings x (6 products + 2
// squarings) + 64 complete adds x 12 products + 3 products to leave
// Montgomery form), about 0.15 ms of the card's integer rate at 1536
// relations; bytes are 3 x 96 x 64 in and 3 x 48 out a relation.  What
// sets the time at the widths the batched prover sends (96-1536
// relations, 3-48 warps of one lane a relation on 132 SMs) is a relation's
// chain of dependent products: a product's carry chains run as ordered
// asm (fq_cc.cuh), so one lane never has two in flight, and nothing else
// on a nearly empty card hides their latency (~1 us a product).
//
// Design: a group of HORNER_G lanes a relation (g1_horner.cuh).  Each lane
// holds the accumulator; a point operation is two levels of independent
// products (the complete add six and six, the complete doubling four and
// four), each lane computing the product of its role and the group
// exchanging them by shuffles, so a relation's chain is 641 products
// where one thread's was 3,843 (the reference's 320 complete adds).  The
// 256 doublings use the complete doubling, whose coordinates on the curve
// are the complete self-add's, so the words are the reference's
// (array-equal to `g1_horner_plain`).  The [24, n_rel, 64] window sums are
// relation-major (a relation's 64 sums of a limb row are contiguous), so a
// warp, which holds 32 / HORNER_G relations, stages 8 windows of them at a
// time through shared memory: one load instruction reads 4 relations x 8
// windows, four whole 32-byte sectors, and a lane then reads the
// coordinates its role needs from shared memory.  A group past the last
// relation runs the last one again (the shuffles need the whole warp) and
// stores nothing.  HORNER_G = 8 (4 relations a warp; the add uses 6 lanes
// a level, the doubling 4) against 4 (the add two rounds a level), timed
// in turns on an H100 (PERF.md); 128 threads a block.
#include <cuda_runtime.h>

#include "g1_horner.cuh"

namespace {

constexpr int HORNER_G = 8;                  // lanes a relation
constexpr int RELS = 32 / HORNER_G;          // relations a warp
constexpr int HORNER_THREADS = 128;
constexpr int CHUNK = 8;   // windows staged at once: a sector of a row
constexpr int WORDS = 36;  // x, y, z: 12 words each
// one window of a warp's relations, padded to 4 mod 32 words, so that the
// 4 relations x 8 windows of one staging store fall in 32 banks
constexpr int WIN_STRIDE = WORDS * RELS + (36 - WORDS * RELS % 32) % 32;
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

// The group's products by shuffles: a lane is one role.  (Its methods and
// the staged windows' are host-device, as the schedule is, with the warp's
// intrinsics in the device pass alone; only the kernel calls them.)
template <int G_>
struct ShuffleExchange {
  static constexpr int G = G_, HERE = 1;
  int r;
  cc::Fq mine;
  CC_HD int role(int) const { return r; }
  CC_HD void put(int, const cc::Fq& m) { mine = m; }
  CC_HD cc::Fq get(int src) const {
#ifdef __CUDA_ARCH__
    cc::Fq o;
#pragma unroll
    for (int i = 0; i < cc::NL; ++i)
      o.v[i] = __shfl_sync(0xffffffffu, mine.v[i], src, G);
    return o;
#else
    (void)src;
    return mine;
#endif
  }
};

// The window sums of a warp's RELS relations, staged 8 windows at a time.
// Every lane of the warp calls `open` with the same w, from 63 down.
struct StagedWindows {
  const uint32_t *x, *y, *z;
  int64_t n_rel, rel0;  // rel0: the warp's first relation
  uint32_t* st;         // the warp's stage: [window][coordinate word][rel]
  int lane, group;

  CC_HD void stage(int w0) {
    const int win = lane & (CHUNK - 1);
    const int64_t stride = n_rel * cc::HORNER_WINDOWS;
    const uint32_t* rows[3] = {x, y, z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll 1
      for (int i = 0; i < cc::NL; ++i) {
#pragma unroll
        for (int k = 0; k < RELS * CHUNK / 32; ++k) {
          const int rl = (32 * k + lane) / CHUNK;
          const int64_t rel = rel0 + rl < n_rel ? rel0 + rl : n_rel - 1;
          const uint32_t* p =
              rows[c] + 2 * i * stride + rel * cc::HORNER_WINDOWS + w0 + win;
          st[win * WIN_STRIDE + (c * cc::NL + i) * RELS + rl] =
              ldg(p) | (ldg(p + stride) << 16);
        }
      }
    }
  }

  CC_HD void open(int w) {
    if ((w & (CHUNK - 1)) == CHUNK - 1) {
      syncwarp();  // the warp has read the last chunk
      stage(w - (CHUNK - 1));
      syncwarp();
    }
  }

  CC_HD cc::Fq at(int w, int c) const {
    const uint32_t* s =
        st + (w & (CHUNK - 1)) * WIN_STRIDE + c * cc::NL * RELS + group;
    cc::Fq r;
#pragma unroll
    for (int i = 0; i < cc::NL; ++i) r.v[i] = s[i * RELS];
    return r;
  }
};

__global__ void __launch_bounds__(HORNER_THREADS)
g1_horner_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ z, uint32_t* __restrict__ out,
                 int64_t n_rel) {
  __shared__ uint32_t stage[HORNER_THREADS / 32 * WARP_STAGE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t rel0 =
      ((int64_t)blockIdx.x * (HORNER_THREADS / 32) + warp) * RELS;
  if (rel0 >= n_rel) return;  // the whole warp lies past the last relation
  const int group = lane / HORNER_G;
  ShuffleExchange<HORNER_G> ex{lane % HORNER_G, {}};
  StagedWindows win{x, y, z, n_rel, rel0, stage + warp * WARP_STAGE, lane,
                    group};
  const cc::Proj acc = cc::horner_group(ex, win);
  cc::store_group(ex, out, n_rel, rel0 + group, rel0 + group < n_rel, acc);
}

}  // namespace

// x, y, z: [24, n_rel, 64] Montgomery window sums; out: [3, 24, n_rel]
// canonical points
extern "C" int cp_g1_horner(const void* x, const void* y, const void* z,
                            void* out, int64_t n_rel, void* stream) {
  constexpr int rels_a_block = HORNER_THREADS / HORNER_G;
  const unsigned blocks =
      (unsigned)((n_rel + rels_a_block - 1) / rels_a_block);
  g1_horner_kernel<<<blocks, HORNER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)out, n_rel);
  return (int)cudaGetLastError();
}
