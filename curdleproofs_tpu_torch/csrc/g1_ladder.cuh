// k * P for one lane by the GLV split and signed 4-bit windows: the body of
// the g1_ladder kernels (g1_ladder.cu), kept in a header so that the host
// C++ harness (tests/test_torch_ladders.py) runs the very chains the kernel
// runs, on fq_cc.cuh's C twin.
//
// The scalar arrives split (ops/kernels.py, `glv_split`, on the host):
// k = k1 + k2 * lambda (mod r), |k1|, |k2| < 2^129, where
// lambda * (x : y : z) = phi(x : y : z) = (beta x : y : z) on G1.  A half is
// its magnitude in GLV_HALF_WORDS little-endian words, its sign in bit 31
// of the last.  The chain reads it as 33 signed radix-16 digits by Booth's
// rule, digit j = b(4j-1) + b(4j) + 2 b(4j+1) + 4 b(4j+2) - 8 b(4j+3) in
// [-8, 8] (b(-1) = 0), negated for a negative half: each digit from five
// bits of the magnitude alone, so no carry runs from window to window.  A
// half's chain runs its windows from the top: four doublings, then the add
// of |d| Q (y negated for d < 0) from a table of Q..8Q built per lane,
// skipped for d = 0, where Q is P for half 1 and phi(P) for half 2; the
// two chains join by one complete add (the kernel runs them in two threads
// of a warp).
// The adds come in another order than the reference's 255-step ladder
// (curdleproofs_tpu/ops/msm.py:36-66), so the outputs are other projective
// representatives of the same points: they equal `g1_ladder_plain`'s after
// affine normalization.  The uniform entries' chains skip the windows above
// the highest nonzero digit of either half, whose doublings act on infinity
// (0 : 1 : 0) and give it back word for word, so every entry gives, lane by
// lane, the words of the per-point entry on the same scalar.
#pragma once

#include "fq_cc.cuh"

namespace cc {

constexpr int GLV_WINDOWS = 33;      // Booth digits over a half < 2^129
constexpr int GLV_HALF_WORDS = 5;    // a half's magnitude, and its sign
constexpr int GLV_TABLE = 8;         // P, 2P, ..., 8P
constexpr int POINT_WORDS = 3 * NL;  // x, y, z

// beta * 2^384 mod q, the cube root of unity of phi in Montgomery form
// (host/glv.py's BETA; tests/test_torch_ladders.py holds the two equal)
CC_HD constexpr uint32_t beta_limb(int i) {
  return i == 0 ? 0x798a64e8u : i == 1 ? 0x30f1361bu : i == 2 ? 0x7ece5a2au
       : i == 3 ? 0xf3b8ddabu : i == 4 ? 0xc61577f7u : i == 5 ? 0x16a8ca3au
       : i == 6 ? 0x74fd029bu : i == 7 ? 0xc26a2ff8u : i == 8 ? 0x60701c6eu
       : i == 9 ? 0x3636b766u : i == 10 ? 0x241b6160u : 0x051ba4abu;
}

// phi(P) = (beta x : y : z) = lambda P
CC_HD Proj glv_phi(const Proj& p) {
  Fq b;
#pragma unroll
  for (int i = 0; i < NL; ++i) b.v[i] = beta_limb(i);
  return Proj{fq_mul(p.x, b), p.y, p.z};
}

// One lane's table of P..8P: word w of entry e at base[(e * 36 + w) *
// stride] (on the card a block's tables interleave in shared memory, one
// column a thread; the host harness uses a local array, stride 1).
struct Table {
  uint32_t* base;
  int stride;

  CC_HD void set(int e, const Proj& p) const {
    uint32_t* s = base + e * POINT_WORDS * stride;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      s[i * stride] = p.x.v[i];
      s[(NL + i) * stride] = p.y.v[i];
      s[(2 * NL + i) * stride] = p.z.v[i];
    }
  }

  CC_HD Proj get(int e) const {
    const uint32_t* s = base + e * POINT_WORDS * stride;
    Proj p;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      p.x.v[i] = s[i * stride];
      p.y.v[i] = s[(NL + i) * stride];
      p.z.v[i] = s[(2 * NL + i) * stride];
    }
    return p;
  }
};

// P, then (e+1) P = eP + P for e = 1..7 (the first the complete add's
// doubling): seven adds through one call site
CC_HD void glv_table(const Table& t, const Proj& p) {
  t.set(0, p);
  Proj a = p;
#pragma unroll 1
  for (int e = 1; e < GLV_TABLE; ++e) {
    a = g1_add(a, t.get(0));
    t.set(e, a);
  }
}

// |d| P from the table, y negated for d < 0 (d != 0); an entry at infinity
// (z = 0) stays as it is
CC_HD Proj glv_entry(const Table& t, int d) {
  Proj e = t.get((d < 0 ? -d : d) - 1);
  const Fq ny = fq_sub(fq_zero(), e.y);
  uint32_t z = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) z |= e.z.v[i];
  const bool neg = d < 0 && z != 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) e.y.v[i] = neg ? ny.v[i] : e.y.v[i];
  return e;
}

// The digits of a half: word w of this lane's half at half[w * stride +
// col] (stride 1 and col 0 for one scalar of a launch).
struct Digits {
  const uint32_t* half;
  int64_t stride, col;

  CC_HD uint32_t word(int w) const {
    const uint32_t v = half[w * stride + col];
    return w == GLV_HALF_WORDS - 1 ? v & 0x7fffffffu : v;
  }

  // Booth digit j from bits 4j-1 .. 4j+3 of the magnitude, with the sign
  CC_HD int operator()(int j) const {
    uint32_t v;
    if (j == 0) {
      v = word(0) << 1;
    } else {
      const int off = 4 * j - 1, w = off >> 5, s = off & 31;
      v = word(w) >> s;
      if (s > 27) v |= word(w + 1) << (32 - s);
    }
    v &= 31;
    const int d = (int)((v >> 1) & 15) + (int)(v & 1) - 16 * (int)(v >> 4);
    return half[(GLV_HALF_WORDS - 1) * stride + col] >> 31 ? -d : d;
  }
};

// The window the chains start from: the highest that holds a nonzero digit
// of either half (0 if none) for one scalar, the top one otherwise.
CC_HD int glv_top(bool uniform, const Digits& d1, const Digits& d2) {
  int top = GLV_WINDOWS - 1;
  if (uniform)
    while (top > 0 && d1(top) == 0 && d2(top) == 0) --top;
  return top;
}

// One half's chain over its table from window `top` down: four doublings
// a window (none at the top), then the add of the digit's entry, skipped
// for a zero digit.  The doublings and the adds each go through one call
// site.
CC_HD Proj glv_chain(const Table& t, const Digits& d, int top) {
  Proj acc = proj_infinity();
#pragma unroll 1
  for (int j = top; j >= 0; --j) {
    if (j != top) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k) acc = g1_double(acc);
    }
    const int dj = d(j);
    if (dj != 0) acc = g1_add(acc, glv_entry(t, dj));
  }
  return acc;
}

// A lane's two digit streams, from its halves: [2, 5] words for one scalar,
// else [2, 5, n]
CC_HD void glv_streams(bool uniform, const uint32_t* halves, int64_t n,
                       int64_t lane, Digits& d1, Digits& d2) {
  const int64_t stride = uniform ? 1 : n, col = uniform ? 0 : lane;
  d1 = Digits{halves, stride, col};
  d2 = Digits{halves + GLV_HALF_WORDS * stride, stride, col};
}

// One lane of a g1_ladder entry, the two threads' operations in one: P
// from the [24, n] limb rows x, y, z, its halves (`uniform`: one scalar's),
// and with `fold` the left point from lx, ly, lz.  Half 1's chain over P's
// table, half 2's over phi(P)'s, joined by k1 P + k2 phi(P), then left +
// that.  `tab` holds a table (GLV_TABLE * POINT_WORDS words).
CC_HD Proj glv_lane(bool uniform, bool fold, const uint32_t* x,
                    const uint32_t* y, const uint32_t* z,
                    const uint32_t* halves, const uint32_t* lx,
                    const uint32_t* ly, const uint32_t* lz, int64_t n,
                    int64_t lane, uint32_t* tab) {
  Digits d1, d2;
  glv_streams(uniform, halves, n, lane, d1, d2);
  const int top = glv_top(uniform, d1, d2);
  const Proj p{load16(x, n, lane), load16(y, n, lane), load16(z, n, lane)};
  const Table t{tab, 1};
  glv_table(t, p);
  const Proj r1 = glv_chain(t, d1, top);
  glv_table(t, glv_phi(p));
  const Proj r = g1_add(r1, glv_chain(t, d2, top));
  if (!fold) return r;
  const Proj l{load16(lx, n, lane), load16(ly, n, lane), load16(lz, n, lane)};
  return g1_add(l, r);
}

}  // namespace cc
