// The Horner step of the grouped MSM for one relation: its 64 window sums
// to the relation's point, as a group of G lanes runs it (g1_horner.cu).
// The schedule is a template over its exchange, so that the host C++
// harness (tests/test_torch_horner.py) runs the very field operations the
// kernel runs, on fq_cc.cuh's C twin.
//
// acc = ((ws[63] * 16 + ws[62]) * 16 + ...) + ws[0]: from acc = infinity,
// each window doubles acc four times, then adds ws[w], for w = 63 down to
// 0, as the JAX package's `horner_device` (curdleproofs_tpu/ops/
// msm_grouped.py:255) does; the three coordinates then leave Montgomery
// form (a product by the plain integer 1).  The reference doubles by the
// complete add of acc to itself (12 products); here a doubling is the
// complete doubling (RCB16 algorithm 9, cc::g1_double's sequence: 6
// products and 2 squarings).  On the curve the two give the same
// coordinates: X3 = 2 X Y (Y^2 - 9 b Z^2), Y3 = Y^4 + 18 b Y^2 Z^2 -
// 27 b^2 Z^4, Z3 = 8 Y^3 Z (the add's Y3 and Z3 reduce to these with
// X^3 Z = Y^2 Z^2 - b Z^4), and every output is canonical, so the words
// stay the reference's; infinity (0 : y : 0) and the all-zero (0, 0, 0)
// rows of the reference's padding included.
//
// A point operation is two levels of independent products (g1_group.cuh):
// the complete add (cc::add_group) six and six, the doubling four and four.
// With G >= 6 a level is one product latency, so a relation's chain is
// 320 x 2 + 1 = 641 products (3,843 when one thread runs the reference's
// 320 complete adds); a smaller G takes ceil(N / G) rounds a level of N
// products.
#pragma once

#include "g1_group.cuh"

namespace cc {

constexpr int HORNER_WINDOWS = 64;  // c = 4: 64 x 4 bits >= 255
constexpr int HORNER_BITS = 4;

// The doubling's levels (cc::g1_double): Y Y, Y Z, Z Z, X Y, then
// t2 z3, t1 z3, t0 y3, t0 xy
struct DoubleL1 {
  const Proj& p;
  CC_HD void operator()(int k, Fq& a, Fq& b) const {
    a = pick(k == 2, p.z, pick(k == 3, p.x, p.y));
    b = pick(k == 0 || k == 3, p.y, p.z);
  }
};

struct DoubleL2 {
  const Fq &t0, &t1, &t2, &y3, &z3, &xy;
  CC_HD void operator()(int k, Fq& a, Fq& b) const {
    a = pick(k == 0, t2, pick(k == 1, t1, t0));
    b = pick(k == 2, y3, pick(k == 3, xy, z3));
  }
};

template <class Ex>
CC_HD Proj double_group(Ex& ex, const Proj& p) {
  Fq m[4];
  level(ex, DoubleL1{p}, m);
  const Fq t0 = m[0];
  Fq z3 = fq_add(t0, t0);
  z3 = fq_add(z3, z3);
  z3 = fq_add(z3, z3);
  Fq t2 = fq_mul_b3(m[2]);
  const Fq y3 = fq_add(t0, t2);
  const Fq t1 = fq_add(t2, t2);
  const Fq t0s = fq_sub(t0, fq_add(t1, t2));
  Fq n[4];
  level(ex, DoubleL2{t0s, m[1], t2, y3, z3, m[3]}, n);
  Proj r;
  r.x = fq_add(n[3], n[3]);
  r.y = fq_add(n[0], n[2]);
  r.z = n[1];
  return r;
}

// The window sums' source gives `open(w)` before window w's add (the
// kernel stages its windows there) and `at(w, c)`, coordinate c of sum w.
template <class Win>
struct WindowCoord {
  Win& win;
  int w;
  CC_HD Fq operator()(int c) const { return win.at(w, c); }
};

template <class Ex, class Win>
CC_HD Proj horner_group(Ex& ex, Win& win) {
  Proj acc = proj_infinity();
#pragma unroll 1
  for (int w = HORNER_WINDOWS - 1; w >= 0; --w) {
#pragma unroll 1
    for (int d = 0; d < HORNER_BITS; ++d) acc = double_group(ex, acc);
    win.open(w);
    WindowCoord<Win> q{win, w};
    acc = add_group(ex, acc, q);
  }
  return acc;
}

// a * 2^-384 mod q: Montgomery form to the canonical integer
CC_HD Fq leave_montgomery(const Fq& a) {
  Fq one = fq_zero();
  one.v[0] = 1;
  return fq_mul(a, one);
}

// Store the point's canonical coordinates into [3, 24, n] rows at column
// `col`, a level of three products: the role that gets coordinate c leaves
// Montgomery form with it and stores it (a role past the three computes
// z again and stores nothing); `store` false (a group past the last
// relation) stores nothing.
template <class Ex>
CC_HD void store_group(Ex& ex, uint32_t* out, int64_t n, int64_t col,
                       bool store, const Proj& p) {
  constexpr int G = Ex::G;
#pragma unroll
  for (int j = 0; j < (3 + G - 1) / G; ++j) {
#pragma unroll 1
    for (int i = 0; i < Ex::HERE; ++i) {
      const int k = j * G + ex.role(i), c = k < 3 ? k : 2;
      const Fq v = leave_montgomery(coord(p, c));
      if (store && k < 3) store16(out + c * 24 * n, n, col, v);
    }
  }
}

// The window sums of one relation read straight from the [24, n_rel, W]
// limb rows (relation-major: its W sums of a limb row are contiguous).
struct DirectWindows {
  const uint32_t *x, *y, *z;
  int64_t n_rel, rel;
  CC_HD void open(int) {}
  CC_HD Fq at(int w, int c) const {
    const uint32_t* rows = c == 0 ? x : c == 1 ? y : z;
    return load16(rows + rel * HORNER_WINDOWS + w, n_rel * HORNER_WINDOWS, 0);
  }
};

}  // namespace cc
