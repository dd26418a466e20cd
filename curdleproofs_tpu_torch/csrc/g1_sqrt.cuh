// The square-root chains of compressed base ingest (g1_sqrt.cu), on the
// carry-chain field core fq_cc.cuh.  Their constants come from the
// generated sqrt_constants.h (ops/kernels.py writes it from constants.py
// into the build directory): B_MONT (the curve's b in Montgomery form), the
// SQRT_NDIGITS two-bit digits of (q+1)/4, most significant first, and its
// SQRT_NBITS bits, least significant first.  Outside nvcc's device pass
// this compiles on the C twin of the core, so a host harness runs the
// chains the kernel runs (tests/test_torch_fq_core.py,
// tests/test_torch_narrow.py).
//
// Both chains compute (x^3 + b)^((q+1)/4) in Montgomery form.  Montgomery
// products are a ring isomorphism, so a chain needs no change of form, and
// every output of the core is a canonical residue: any chain that computes
// this power gives the same words (those of `g1_sqrt_plain`).
#pragma once

#include "g1_group.cuh"
#include "sqrt_constants.h"

namespace cc {

CC_HD Fq sqrt_u(const Fq& x) {
  Fq b;
#pragma unroll
  for (int i = 0; i < NL; ++i) b.v[i] = B_MONT[i];
  return fq_add(fq_mul(fq_mul(x, x), x), b);
}

// u^d for a digit d in 1..3, limb by limb: a select of the struct would
// address u, u^2 and u^3 as an array in local memory
CC_HD Fq pick_digit(int d, const Fq& u, const Fq& u2, const Fq& u3) {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = d == 1 ? u.v[i] : d == 2 ? u2.v[i] : u3.v[i];
  return r;
}

// One thread a point: the TPU kernel's chain (`_k_sqrt_candidate`).  Each
// digit squares twice and multiplies by u^d.  The TPU kernel starts from
// Montgomery one and multiplies by it on zero digits; canonical residues
// make one * one = one and a * one = a, so leaving those products out
// keeps every step's residue the plain version's.  The digit is the same
// for every lane, so skipping costs no divergence.  380 squarings and 158
// products in one chain.
CC_HD Fq sqrt_candidate(const Fq& x) {
  const Fq u = sqrt_u(x);
  const Fq u2 = fq_mul(u, u);
  const Fq u3 = fq_mul(u2, u);
  int j = 0;
  while (SQRT_DIGITS[j] == 0) ++j;  // (q+1)/4 > 0: some digit is not 0
  Fq acc = pick_digit(SQRT_DIGITS[j], u, u2, u3);
#pragma unroll 1
  for (++j; j < SQRT_NDIGITS; ++j) {
    acc = fq_mul(acc, acc);
    acc = fq_mul(acc, acc);
    const int d = SQRT_DIGITS[j];
    if (d != 0) acc = fq_mul(acc, pick_digit(d, u, u2, u3));
  }
  return acc;
}

// A pair of lanes a point: the right-to-left binary method in lockstep.
// Step i is a level of two products: the square role (0) computes
// s_{i+1} = s_i s_i, the product role (1) acc s_i, which acc keeps where
// bit i of (q+1)/4 is set (a select, the same for both lanes).  Both lanes
// then hold s_{i+1} and acc.  The chain is x^2, x^3 and SQRT_NBITS levels:
// 381 product latencies where one thread's chain is 538 products.
struct SqrtStep {
  const Fq &s, &acc;
  CC_HD void operator()(int k, Fq& a, Fq& b) const {
    a = pick(k == 0, s, acc);
    b = s;
  }
};

template <class Ex>
CC_HD Fq sqrt_pair(Ex& ex, const Fq& x) {
  Fq s = sqrt_u(x);
  Fq acc = fq_one_mont();
#pragma unroll 1
  for (int i = 0; i < SQRT_NBITS; ++i) {
    Fq m[2];
    level(ex, SqrtStep{s, acc}, m);
    acc = pick(SQRT_BITS[i] != 0, m[1], acc);
    s = m[0];
  }
  return acc;
}

}  // namespace cc
