// The Horner step of the grouped MSM for one relation: its 64 window sums
// to the relation's point, the body of the g1_horner kernel (g1_horner.cu),
// kept in a header so that the host C++ harness (tests/test_torch_horner.py)
// runs the very chain the kernel runs, on fq_cc.cuh's C twin.
//
// acc = ((ws[63] * 16 + ws[62]) * 16 + ...) + ws[0]: from acc = infinity,
// each window makes four complete adds of acc to itself, then acc + ws[w],
// for w = 63 down to 0: the JAX package's `horner_device`
// (curdleproofs_tpu/ops/msm_grouped.py:255) operation for operation, since
// it doubles by the complete add too, so the projective representatives are
// the reference's.  The three coordinates then leave Montgomery form (a
// product by the plain integer 1), as its closing `FQ.mul`s do.
#pragma once

#include "fq_cc.cuh"

namespace cc {

constexpr int HORNER_WINDOWS = 64;  // c = 4: 64 x 4 bits >= 255
constexpr int HORNER_BITS = 4;

// `win(w)` gives window sum w of this lane's relation.  The 320 adds run
// through one call site of g1_add (a step adds acc, or at a window's fifth
// step its sum), so the kernel inlines the complete add once.
template <class Win>
CC_HD Proj horner(Win& win) {
  constexpr int STEPS = HORNER_BITS + 1;
  Proj acc = proj_infinity();
#pragma unroll 1
  for (int s = 0; s < HORNER_WINDOWS * STEPS; ++s) {
    Proj q = acc;
    if (s % STEPS == HORNER_BITS) q = win(HORNER_WINDOWS - 1 - s / STEPS);
    acc = g1_add(acc, q);
  }
  return acc;
}

// a * 2^-384 mod q: Montgomery form to the canonical integer
CC_HD Fq leave_montgomery(const Fq& a) {
  Fq one = fq_zero();
  one.v[0] = 1;
  return fq_mul(a, one);
}

// The window sums of one relation read straight from the [24, n_rel, W]
// limb rows (relation-major: its W sums of a limb row are contiguous).
struct DirectWindows {
  const uint32_t *x, *y, *z;
  int64_t n_rel, rel;
  CC_HD Proj operator()(int w) const {
    const int64_t at = rel * HORNER_WINDOWS + w, stride = n_rel * HORNER_WINDOWS;
    return Proj{load16(x + at, stride, 0), load16(y + at, stride, 0),
                load16(z + at, stride, 0)};
  }
};

// Store a point's canonical coordinates into [3, 24, n] rows at column
// `lane` (one call site of the product for the three).
CC_HD void store_canonical(uint32_t* out, int64_t n, int64_t lane,
                           const Proj& p) {
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    Fq v;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      v.v[i] = c == 0 ? p.x.v[i] : c == 1 ? p.y.v[i] : p.z.v[i];
    store16(out + c * 24 * n, n, lane, leave_montgomery(v));
  }
}

}  // namespace cc
