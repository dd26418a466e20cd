// The double-and-add ladder of one lane, k * P from the top bit of k down:
// the body of the g1_ladder kernels (g1_ladder.cu), kept in a header so that
// the host C++ harness (tests/test_torch_ladders.py) runs the very lane the
// kernel runs, on fq_cc.cuh's C twin.
//
// A scalar is eight 32-bit words, little-endian (the wrapper packs the
// reference's bit array, `ints_to_bits(s % r, 255)`, into them).  Each step
// is the JAX package's `lax.scan` step (curdleproofs_tpu/ops/msm.py:36-60):
// acc = double(acc), then acc + P where the bit is set, from acc = infinity
// at bit 254 down to bit 0.  With the port's doubling and complete add in the
// reference's operation order every step gives the reference's words.
#pragma once

#include "fq_cc.cuh"

namespace cc {

constexpr int LADDER_BITS = 255;  // r < 2^255
constexpr int SCALAR_WORDS = 8;

// word k of a scalar held in registers, for a k known only at run time: a
// chain of selects, so the words never go to local memory
CC_HD uint32_t scalar_word(const uint32_t (&w)[SCALAR_WORDS], int k) {
  uint32_t r = w[0];
#pragma unroll
  for (int j = 1; j < SCALAR_WORDS; ++j) r = k == j ? w[j] : r;
  return r;
}

CC_HD bool scalar_bit(const uint32_t (&w)[SCALAR_WORDS], int i) {
  return (scalar_word(w, i >> 5) >> (i & 31)) & 1u;
}

// k * P.  UNIFORM (one scalar for every lane of a launch): a step whose bit
// is 0 skips the add, whose sum the reference's select drops, and the steps
// above the top set bit are skipped, since the doubling maps infinity
// (0 : 1 : 0) to itself word for word; the words are the reference's all the
// same.  Per lane: every step doubles, adds and selects, as the reference
// does (the lanes of a warp differ in their bits).
template <bool UNIFORM>
CC_HD Proj ladder(const Proj& p, const uint32_t (&w)[SCALAR_WORDS]) {
  Proj acc = proj_infinity();
  int top = LADDER_BITS - 1;
  if (UNIFORM)
    while (top >= 0 && !scalar_bit(w, top)) --top;
#pragma unroll 1
  for (int i = top; i >= 0; --i) {
    acc = g1_double(acc);
    const bool bit = scalar_bit(w, i);
    if (UNIFORM) {
      if (bit) acc = g1_add(acc, p);
    } else {
      const Proj sum = g1_add(acc, p);
      acc = bit ? sum : acc;
    }
  }
  return acc;
}

// One lane of a g1_ladder kernel: P from the [24, n] limb rows x, y, z, its
// scalar from `words` ([8], or with !UNIFORM [8, n], word-major), and with
// FOLD the left point from lx, ly, lz: k * P, or L + k * P (the reference's
// `fold_kernel` adds the left point first).
template <bool UNIFORM, bool FOLD>
CC_HD Proj ladder_lane(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                       const uint32_t* words, const uint32_t* lx,
                       const uint32_t* ly, const uint32_t* lz, int64_t n,
                       int64_t lane) {
  uint32_t w[SCALAR_WORDS];
#pragma unroll
  for (int k = 0; k < SCALAR_WORDS; ++k)
    w[k] = UNIFORM ? words[k] : words[k * n + lane];
  const Proj p{load16(x, n, lane), load16(y, n, lane), load16(z, n, lane)};
  const Proj r = ladder<UNIFORM>(p, w);
  if (!FOLD) return r;
  const Proj l{load16(lx, n, lane), load16(ly, n, lane), load16(lz, n, lane)};
  return g1_add(l, r);
}

}  // namespace cc
