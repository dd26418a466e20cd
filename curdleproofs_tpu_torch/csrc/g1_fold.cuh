// The Pippenger bucket fold over resident bases, shared by its two kernels:
// g1_fold_madd.cu (the mixed-add fold, dead rows skipped) and
// g1_fold_packed.cu (the words of the complete add on every row).
//
// Resident bases are [P | -P | inf] as [12, E] packed limb pairs of x and
// of y, and an [E] liveness bit: z is Montgomery one where it is set, 0
// where not (input infinities and the plan's sentinel).  For each slot s
// the fold accumulates the T bases ext[plan[t, s]], t = 0..T-1.
//
// Design (the first version's faults on the 626k plan, PERF.md):
// - gathers: the limb-major [12, E] layout puts a base's 96 bytes in 24
//   sectors of 32 bytes.  A launch first repacks x and y point-major into an
//   [E, 24] scratch (x words, then y: 96 contiguous bytes, three sectors),
//   a pass over 2 x 48 E bytes, and the fold reads a row as six 16-byte
//   loads;
// - one thread a slot walks the rows in plan order with the accumulator in
//   registers (on the TPU the grid carried it from one step to the next), so
//   each slot's sum, projective representative included, equals the plain
//   version's;
// - arithmetic: the carry-chain core fq_cc.cuh, each product inlined.
//
// The slot loop is templated on the row step:
// - MaddRow: live rows take the 11-product mixed add; dead rows keep the
//   accumulator and are not loaded (`g1_fold_rows_madd_pallas`);
// - FullRow: every row gives the words of the 12-product complete add
//   g1_add(acc, (x2, y2, z2)), dead rows too, since P + infinity changes P's
//   representative (`g1_fold_rows_packed_pallas`).  Every dead row the
//   ingest makes is (0 : +-1 : 0), and for z2 = 0, x2 = 0 the complete add
//   reduces to P scaled by v = Y1 y2^2 (`g1_add_inf`): algorithm 7 gives
//   (X1 v, u^2, Z1 v) with u = Y1 y2, v = u y2, and u^2 = Y1 v.  That is 3
//   products, 2 more for v where y2 is not +-one (v = Y1 there); canonical
//   residues are unique, so the same field elements are the same words.
//   Live and dead rows meet in most warps (each bucket's last slot is
//   partly filled), where a branch in each lane runs both steps in turn.
//   So the warp votes: a warp row of (0 : y : 0) rows alone scales, any
//   other takes the complete add on every lane.  (The mixed add gives the
//   complete add's words on a live row too, but a third inlined step, for
//   warp rows of live rows alone, made the kernel slower, PERF.md.)
//
// Every function above the kernels is CC_HD, so tests/test_torch_fq_core.py
// runs the slot loop, both row steps and the repack on the C twin; there a
// warp is one lane.
#pragma once

#include "fq_cc.cuh"

namespace cc {

// a read-only load, through the non-coherent cache on the card
template <class T>
CC_HD T ld_ro(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// whether p holds on every active lane of the warp (the C twin: one lane)
CC_HD bool warp_all(bool p) {
#ifdef __CUDA_ARCH__
  return __all_sync(__activemask(), p) != 0;
#else
  return p;
#endif
}

CC_HD bool fq_is_zero(const Fq& a) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) w |= a.v[i];
  return w == 0;
}

// limb i of q - one (the Montgomery form of -1)
CC_HD constexpr uint32_t neg_one_limb(int i) {
  uint64_t borrow = 0;
  uint32_t w = 0;
  for (int k = 0; k <= i; ++k) {
    const uint64_t d = (uint64_t)q_limb(k) - one_limb(k) - borrow;
    w = (uint32_t)d;
    borrow = d >> 63;
  }
  return w;
}

// a = one or a = q - one
CC_HD bool fq_is_pm_one(const Fq& a) {
  uint32_t pos = 0, neg = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    pos |= a.v[i] ^ one_limb(i);
    neg |= a.v[i] ^ neg_one_limb(i);
  }
  return pos == 0 || neg == 0;
}

// P + (0 : y2 : 0), the complete add's words: P scaled by v = Y1 y2^2,
// which is Y1 where y2 = +-one
CC_HD Proj g1_add_inf(const Proj& p, const Fq& y2) {
  Fq v = p.y;
  if (!fq_is_pm_one(y2)) v = fq_mul(fq_mul(p.y, y2), y2);
  return Proj{fq_mul(p.x, v), fq_mul(p.y, v), fq_mul(p.z, v)};
}

// [12, E] packed pairs of x and y -> row e of the [E, 24] scratch
CC_HD void repack_point(const uint32_t* ext_px, const uint32_t* ext_py,
                        int64_t n_ext, int64_t e, uint32_t* pts) {
  uint32_t w[2 * NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    w[i] = ld_ro(ext_px + i * n_ext + e);
    w[NL + i] = ld_ro(ext_py + i * n_ext + e);
  }
#ifdef __CUDA_ARCH__
  uint4* row = reinterpret_cast<uint4*>(pts + e * 2 * NL);
#pragma unroll
  for (int k = 0; k < NL / 2; ++k)
    row[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
#else
  for (int i = 0; i < 2 * NL; ++i) pts[e * 2 * NL + i] = w[i];
#endif
}

// row e of the [E, 24] scratch: six 16-byte loads on the card
CC_HD void load_point(const uint32_t* pts, int64_t e, Fq& x2, Fq& y2) {
  uint32_t w[2 * NL];
#ifdef __CUDA_ARCH__
  const uint4* row = reinterpret_cast<const uint4*>(pts + e * 2 * NL);
#pragma unroll
  for (int k = 0; k < NL / 2; ++k) {
    const uint4 u = __ldg(row + k);
    w[4 * k] = u.x;
    w[4 * k + 1] = u.y;
    w[4 * k + 2] = u.z;
    w[4 * k + 3] = u.w;
  }
#else
  for (int i = 0; i < 2 * NL; ++i) w[i] = pts[e * 2 * NL + i];
#endif
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    x2.v[i] = w[i];
    y2.v[i] = w[NL + i];
  }
}

struct MaddRow {
  static constexpr bool kDeadRows = false;  // dead rows keep the accumulator
  CC_HD static Proj add(const Proj& acc, const Fq& x2, const Fq& y2,
                        uint32_t) {
    return g1_madd(acc, x2, y2);
  }
};

struct FullRow {
  static constexpr bool kDeadRows = true;
  CC_HD static Proj add(const Proj& acc, const Fq& x2, const Fq& y2,
                        uint32_t zb) {
    if (warp_all(zb == 0 && fq_is_zero(x2))) return g1_add_inf(acc, y2);
    return g1_add(acc, Proj{x2, y2, zb != 0 ? fq_one_mont() : fq_zero()});
  }
};

// slot s of the fold: the rows plan[t, s], t = 0..T-1, from infinity
template <class Row>
CC_HD Proj fold_slot(const uint32_t* pts, const uint32_t* ext_zb,
                     const int32_t* plan, int t_rows, int64_t s_pad,
                     int64_t s) {
  Proj acc = proj_infinity();
  for (int t = 0; t < t_rows; ++t) {
    const int64_t e = ld_ro(plan + (int64_t)t * s_pad + s);
    const uint32_t zb = ld_ro(ext_zb + e);
    if (!Row::kDeadRows && zb == 0) continue;
    Fq x2, y2;
    load_point(pts, e, x2, y2);
    acc = Row::add(acc, x2, y2, zb);
  }
  return acc;
}

}  // namespace cc

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int FOLD_THREADS = 128;
// two blocks an SM: ptxas then takes 188 registers for the mixed-add fold
// and spills nothing (at three it fits 154, at four 128 with spills; both
// ran slower on the 626k plan, PERF.md)
constexpr int FOLD_MIN_BLOCKS = 2;
constexpr int REPACK_THREADS = 256;

__global__ void __launch_bounds__(REPACK_THREADS)
g1_fold_repack_kernel(const uint32_t* __restrict__ ext_px,
                      const uint32_t* __restrict__ ext_py, int64_t n_ext,
                      uint32_t* __restrict__ pts) {
  const int64_t e = (int64_t)blockIdx.x * REPACK_THREADS + threadIdx.x;
  if (e < n_ext) cc::repack_point(ext_px, ext_py, n_ext, e, pts);
}

template <class Row>
__global__ void __launch_bounds__(FOLD_THREADS, FOLD_MIN_BLOCKS)
g1_fold_kernel(const uint32_t* __restrict__ pts,
               const uint32_t* __restrict__ ext_zb,
               const int32_t* __restrict__ plan, int t_rows, int64_t s_pad,
               uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
               uint32_t* __restrict__ oz) {
  const int64_t s = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (s >= s_pad) return;
  const cc::Proj acc =
      cc::fold_slot<Row>(pts, ext_zb, plan, t_rows, s_pad, s);
  cc::store16(ox, s_pad, s, acc.x);
  cc::store16(oy, s_pad, s, acc.y);
  cc::store16(oz, s_pad, s, acc.z);
}

// repack into `pts` (n_ext x 24 words of the caller's scratch), then fold
template <class Row>
int g1_fold_launch(const void* ext_px, const void* ext_py, const void* ext_zb,
                   const void* plan, int64_t n_ext, int t_rows, int64_t s_pad,
                   void* pts, void* ox, void* oy, void* oz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  g1_fold_repack_kernel<<<(unsigned)((n_ext + REPACK_THREADS - 1) /
                                     REPACK_THREADS),
                          REPACK_THREADS, 0, st>>>(
      (const uint32_t*)ext_px, (const uint32_t*)ext_py, n_ext,
      (uint32_t*)pts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  g1_fold_kernel<Row>
      <<<(unsigned)((s_pad + FOLD_THREADS - 1) / FOLD_THREADS), FOLD_THREADS,
         0, st>>>((const uint32_t*)pts, (const uint32_t*)ext_zb,
                  (const int32_t*)plan, t_rows, s_pad, (uint32_t*)ox,
                  (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
