// A group of lanes a point: the products of one step of a point's chain
// that do not depend on each other run in different lanes of the group,
// one product latency for the step, and the group exchanges them.  A
// lane's product is an ordered carry chain (fq_cc.cuh), so one lane never
// has two in flight; at the widths where a kernel leaves the card nearly
// empty, nothing else hides that latency.  g1_horner.cuh (the Horner step),
// g1_add.cuh (the complete add at narrow widths) and g1_sqrt.cuh (the
// square root at narrow widths) run their chains on it.
//
// A schedule is a template over its exchange `Ex`, so that a host C++
// harness runs the very field operations a kernel runs (tests/
// test_torch_horner.py, tests/test_torch_narrow.py).  `Ex` gives:
//   G, HERE       the lanes of a group, and the roles one copy of the
//                 schedule computes: 1 on the card (a lane is one role),
//                 G in one host thread (it runs every role in turn);
//   role(i)       the role of this copy's i-th product (i < HERE);
//   put(i, m)     hand over that product;
//   get(r)        the product of role r, on every lane of the group.
//
// In a level each lane picks the operands of the product its role
// computes by selects (a reference chosen at run time would put the
// operands in local memory), so every lane runs one call site of fq_mul
// and the group never diverges.
#pragma once

#include "fq_cc.cuh"

namespace cc {

// c ? a : b, word by word (a select, not a branch)
CC_HD Fq pick(bool c, const Fq& a, const Fq& b) {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// coordinate c of p, by value
CC_HD Fq coord(const Proj& p, int c) {
  return pick(c == 0, p.x, pick(c == 1, p.y, p.z));
}

// the coordinates of a point held in registers, as `add_group` reads q
struct PointCoord {
  const Proj& p;
  CC_HD Fq operator()(int c) const { return coord(p, c); }
};

// One level of N independent products: out[k] = a_k * b_k for k < N, the
// operands from `ops(k, a, b)`.  Round j gives role r product j G + r (the
// last one again where that passes N), so every lane runs the one product
// of a round.
template <int N, class Ex, class Ops>
CC_HD void level(Ex& ex, const Ops& ops, Fq (&out)[N]) {
  constexpr int G = Ex::G;
#pragma unroll
  for (int j = 0; j < (N + G - 1) / G; ++j) {
#pragma unroll 1
    for (int i = 0; i < Ex::HERE; ++i) {
      const int k = j * G + ex.role(i);
      Fq a, b;
      ops(k < N ? k : N - 1, a, b);
      ex.put(i, fq_mul(a, b));
    }
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (j * G + r < N) out[j * G + r] = ex.get(r);
  }
}

// The complete add's levels (cc::g1_add): X1 X2, Y1 Y2, Z1 Z2,
// (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2) (a sum of one
// coordinate and 0 for the first three), then t3 t1, t4 y3, y3 t0, t1 z3,
// z3 t4, t0 t3.  `q(c)` is coordinate c of the point added.
template <class Q>
struct AddL1 {
  const Proj& p;
  Q& q;
  CC_HD void operator()(int k, Fq& a, Fq& b) const {
    const int c1 = k == 3 || k == 5 ? 0 : k == 4 ? 1 : k;
    const int c2 = k == 3 ? 1 : 2;
    const Fq zero = fq_zero();
    a = fq_add(coord(p, c1), pick(k < 3, zero, coord(p, c2)));
    b = fq_add(q(c1), pick(k < 3, zero, q(c2)));
  }
};

struct AddL2 {
  const Fq &t0, &t1, &t3, &t4, &y3, &z3;
  CC_HD void operator()(int k, Fq& a, Fq& b) const {
    a = pick(k == 0, t3, pick(k == 1, t4, pick(k == 2, y3,
        pick(k == 3, t1, pick(k == 4, z3, t0)))));
    b = pick(k == 0, t1, pick(k == 1, y3, pick(k == 2, t0,
        pick(k == 3, z3, pick(k == 4, t4, t3)))));
  }
};

// p + q by the complete add, two levels of six products: the words of
// cc::g1_add (the same field operations; every output canonical)
template <class Ex, class Q>
CC_HD Proj add_group(Ex& ex, const Proj& p, Q& q) {
  Fq m[6];
  level(ex, AddL1<Q>{p, q}, m);
  const Fq t3 = fq_sub(m[3], fq_add(m[0], m[1]));
  const Fq t4 = fq_sub(m[4], fq_add(m[1], m[2]));
  const Fq y3 = fq_mul_b3(fq_sub(m[5], fq_add(m[0], m[2])));
  const Fq t0 = fq_add(fq_add(m[0], m[0]), m[0]);
  const Fq t2 = fq_mul_b3(m[2]);
  const Fq z3 = fq_add(m[1], t2);
  const Fq t1 = fq_sub(m[1], t2);
  Fq n[6];
  level(ex, AddL2{t0, t1, t3, t4, y3, z3}, n);
  Proj r;
  r.x = fq_sub(n[0], n[1]);
  r.y = fq_add(n[2], n[3]);
  r.z = fq_add(n[4], n[5]);
  return r;
}

// The exchange inside one thread: every role of the group in turn.
template <int G_>
struct LoopExchange {
  static constexpr int G = G_, HERE = G_;
  Fq slot[G_];
  CC_HD int role(int i) const { return i; }
  CC_HD void put(int i, const Fq& m) { slot[i] = m; }
  CC_HD Fq get(int r) const { return slot[r]; }
};

// The group's products by shuffles, on the card: a lane is one role, the
// group G neighbouring lanes of a warp.  `mask` names the lanes that
// exchange: the whole warp (every group of it runs the schedule), or the
// group's own where groups of one warp may take different paths (the scan
// step).  (The methods are host-device, as the schedules are, with the
// warp's intrinsics in the device pass alone; only the kernels call them.)
template <int G_>
struct ShuffleExchange {
  static constexpr int G = G_, HERE = 1;
  int r;
  Fq mine;
  uint32_t mask = 0xffffffffu;
  CC_HD int role(int) const { return r; }
  CC_HD void put(int, const Fq& m) { mine = m; }
  CC_HD Fq get(int src) const {
#ifdef __CUDA_ARCH__
    Fq o;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      o.v[i] = __shfl_sync(mask, mine.v[i], src, G);
    return o;
#else
    (void)src;
    return mine;
#endif
  }
};

// The lanes of a warp that form lane's group of G (G divides 32).
CC_HD uint32_t group_mask(int lane, int g) {
  return (g == 32 ? 0xffffffffu : ((1u << g) - 1u)) << (lane / g * g);
}

}  // namespace cc
