// The square-root chain of compressed base ingest (g1_sqrt.cu), on the
// carry-chain field core fq_cc.cuh.  Its constants come from the generated
// sqrt_constants.h (ops/kernels.py writes it from constants.py into the build
// directory): B_MONT (the curve's b in Montgomery form) and the SQRT_NDIGITS
// two-bit digits of (q+1)/4, most significant first.  Outside nvcc's device
// pass this compiles on the C twin of the core, so a host harness runs the
// chain the kernel runs (tests/test_torch_fq_core.py).
#pragma once

#include "fq_cc.cuh"
#include "sqrt_constants.h"

namespace cc {

// (x^3 + b)^((q+1)/4), Montgomery form in and out: the TPU kernel's chain
// (`_k_sqrt_candidate`).  Montgomery products are a ring isomorphism, so the
// chain needs no change of form.  Each digit squares twice and multiplies by
// u^d.  The TPU kernel starts from Montgomery one and multiplies by it on
// zero digits; canonical residues make one * one = one and a * one = a, so
// leaving those products out keeps every step's residue the plain version's.
// The digit is the same for every lane, so skipping costs no divergence.
// u^d for a digit d in 1..3, limb by limb: a select of the struct would
// address u, u^2 and u^3 as an array in local memory
CC_HD Fq pick(int d, const Fq& u, const Fq& u2, const Fq& u3) {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = d == 1 ? u.v[i] : d == 2 ? u2.v[i] : u3.v[i];
  return r;
}

CC_HD Fq sqrt_candidate(const Fq& x) {
  Fq b;
#pragma unroll
  for (int i = 0; i < NL; ++i) b.v[i] = B_MONT[i];
  const Fq u = fq_add(fq_mul(fq_mul(x, x), x), b);
  const Fq u2 = fq_mul(u, u);
  const Fq u3 = fq_mul(u2, u);
  int j = 0;
  while (SQRT_DIGITS[j] == 0) ++j;  // (q+1)/4 > 0: some digit is not 0
  Fq acc = pick(SQRT_DIGITS[j], u, u2, u3);
#pragma unroll 1
  for (++j; j < SQRT_NDIGITS; ++j) {
    acc = fq_mul(acc, acc);
    acc = fq_mul(acc, acc);
    const int d = SQRT_DIGITS[j];
    if (d != 0) acc = fq_mul(acc, pick(d, u, u2, u3));
  }
  return acc;
}

}  // namespace cc
