// The square-root chain of compressed base ingest (g1_sqrt.cu), on the field
// arithmetic of bls12_381.cuh.  Its constants come from the generated
// sqrt_constants.h (ops/kernels.py writes it from constants.py into the build
// directory): B_MONT (the curve's b in Montgomery form) and the SQRT_NDIGITS
// two-bit digits of (q+1)/4, most significant first.
#pragma once

#include "bls12_381.cuh"
#include "sqrt_constants.h"

namespace cp {

// (x^3 + b)^((q+1)/4), Montgomery form in and out: the TPU kernel's chain
// (`_k_sqrt_candidate`).  Montgomery products are a ring isomorphism, so the
// chain needs no change of form.  Each digit squares twice and multiplies by
// u^d, with u^0 = Montgomery one.
CP_DEV Fq sqrt_candidate(const Fq& x) {
  Fq b;
#pragma unroll
  for (int i = 0; i < NL; ++i) b.v[i] = B_MONT[i];
  const Fq u = fq_add(fq_mul(fq_mul(x, x), x), b);
  const Fq u2 = fq_mul(u, u);
  const Fq u3 = fq_mul(u2, u);
  const Fq one = fq_one_mont();
  Fq acc = one;
#pragma unroll 1
  for (int j = 0; j < SQRT_NDIGITS; ++j) {
    acc = fq_mul(acc, acc);
    acc = fq_mul(acc, acc);
    const int d = SQRT_DIGITS[j];
    acc = fq_mul(acc, d == 1 ? u : d == 2 ? u2 : d == 3 ? u3 : one);
  }
  return acc;
}

}  // namespace cp
