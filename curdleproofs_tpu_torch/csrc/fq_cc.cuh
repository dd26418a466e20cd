// BLS12-381 base field, the complete adds (mixed and full) and the complete
// doubling on carry chains: the port's field core.  Every kernel runs on it:
// the bucket folds (g1_fold_madd.cu and g1_fold_packed.cu through
// g1_fold.cuh), the fold of gathered rows (g1_fold_rows.cu through
// g1_fold_rows.cuh), the complete add and the scan step around it
// (g1_add.cu), the square root of compressed ingest (g1_sqrt.cu through
// g1_sqrt.cuh), the bucket reduction's inner step (g1_suffix_weighted.cu
// through g1_suffix_weighted.cuh), the batched product (fq_mul.cu) and the
// double-and-add ladders (g1_ladder.cu).
//
// The numbers are the JAX package's: 12 x 32-bit limbs (its 24 16-bit limbs
// in pairs), little-endian, Montgomery form with R = 2^384, every output
// canonical (< q).  Canonical Montgomery residues are unique, so each
// function here returns the same words as the JAX package's function of the
// same sequence of field operations, and the kernels stay array-equal to
// their plain versions.
//
// A product is a CIOS loop in which each 32x32 product is two multiply-adds
// that carry in the condition-code flag:
//   mad.lo.cc / madc.lo.cc  t[j]   += lo(a_j * b) + carry
//   madc.hi.cc              t[j+1] += hi(a_j * b) + carry
// and the modular add and subtract run add.cc / sub.cc chains.  The
// product keeps its running sum in an even and an odd half so that each
// 32x32 product is one wide multiply-add on an aligned register pair (see
// `fq_mul`): ptxas then needs no moves to line the pairs up.
//
// On the card (__CUDA_ARCH__) each primitive is one PTX instruction in an
// `asm volatile`, so the chains keep their order and nothing the compiler
// emits between two of them touches the flag.  Everywhere else the header
// compiles a portable C twin of the same functions: the same chains, with the
// flag in an explicit `Carry`, so a host C++ harness runs the very sequences
// the kernel runs (tests/test_torch_fq_core.py).  The PTX itself is held
// only on the card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define CC_HD __host__ __device__ __forceinline__
#define CC_CONST __constant__  // tables every lane reads in the same step
#else
#define CC_HD inline
#define CC_CONST
#endif

namespace cc {

constexpr int NL = 12;  // 32-bit limbs per field element

struct Fq {
  uint32_t v[NL];
};

struct Proj {  // homogeneous projective (X : Y : Z); infinity is (0 : 1 : 0)
  Fq x, y, z;
};

// q, R mod q (Montgomery one) and -q^-1 mod 2^32, as functions of a constant
// index so that unrolled loops see immediates.
CC_HD constexpr uint32_t q_limb(int i) {
  return i == 0 ? 0xffffaaabu : i == 1 ? 0xb9feffffu : i == 2 ? 0xb153ffffu
       : i == 3 ? 0x1eabfffeu : i == 4 ? 0xf6b0f624u : i == 5 ? 0x6730d2a0u
       : i == 6 ? 0xf38512bfu : i == 7 ? 0x64774b84u : i == 8 ? 0x434bacd7u
       : i == 9 ? 0x4b1ba7b6u : i == 10 ? 0x397fe69au : 0x1a0111eau;
}
CC_HD constexpr uint32_t one_limb(int i) {
  return i == 0 ? 0x0002fffdu : i == 1 ? 0x76090000u : i == 2 ? 0xc40c0002u
       : i == 3 ? 0xebf4000bu : i == 4 ? 0x53c758bau : i == 5 ? 0x5f489857u
       : i == 6 ? 0x70525745u : i == 7 ? 0x77ce5853u : i == 8 ? 0xa256ec6du
       : i == 9 ? 0x5c071a97u : i == 10 ? 0xfa80e493u : 0x15f65ec3u;
}
constexpr uint32_t N0 = 0xfffcfffdu;

// --- carry-chain primitives --------------------------------------------------
//
// A chain starts with a primitive that takes no carry in (add_cc, sub_cc,
// mad_lo_cc) and ends with one that gives none out (addc, subc, madc_hi).
// On the card the flag is the one condition code, so chains must not
// interleave in program order; `Carry` is empty there.

struct Carry {
#ifndef __CUDA_ARCH__
  uint32_t cf = 0;  // the host twin's flag: carry 1, or borrow 1
#endif
};

#ifdef __CUDA_ARCH__
#define CC_ASM(insn, ...) asm volatile(insn : __VA_ARGS__)
#endif

CC_HD uint32_t add_cc(Carry& c, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("add.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  uint64_t s = (uint64_t)a + b;
  c.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

CC_HD uint32_t addc_cc(Carry& c, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("addc.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  uint64_t s = (uint64_t)a + b + c.cf;
  c.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

CC_HD uint32_t addc(Carry& c, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("addc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return a + b + c.cf;
#endif
}

CC_HD uint32_t sub_cc(Carry& c, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("sub.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  c.cf = a < b;
  return a - b;
#endif
}

CC_HD uint32_t subc_cc(Carry& c, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("subc.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  uint64_t d = (uint64_t)a - b - c.cf;
  c.cf = (uint32_t)(d >> 63);
  return (uint32_t)d;
#endif
}

CC_HD uint32_t subc(Carry& c, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("subc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return a - b - c.cf;
#endif
}

// x + lo(a * b), carry out
CC_HD uint32_t mad_lo_cc(Carry& c, uint32_t a, uint32_t b, uint32_t x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("mad.lo.cc.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(x));
  return r;
#else
  uint64_t s = (uint64_t)(uint32_t)(a * b) + x;
  c.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// x + lo(a * b) + carry, carry out
CC_HD uint32_t madc_lo_cc(Carry& c, uint32_t a, uint32_t b, uint32_t x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("madc.lo.cc.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(x));
  return r;
#else
  uint64_t s = (uint64_t)(uint32_t)(a * b) + x + c.cf;
  c.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// x + hi(a * b) + carry, carry out
CC_HD uint32_t madc_hi_cc(Carry& c, uint32_t a, uint32_t b, uint32_t x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("madc.hi.cc.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(x));
  return r;
#else
  uint64_t s = (((uint64_t)a * b) >> 32) + x + c.cf;
  c.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// x + hi(a * b) + carry, no carry out
CC_HD uint32_t madc_hi(Carry& c, uint32_t a, uint32_t b, uint32_t x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  CC_ASM("madc.hi.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(x));
  return r;
#else
  return (uint32_t)(((uint64_t)a * b) >> 32) + x + c.cf;
#endif
}

// --- field --------------------------------------------------------------------

CC_HD Fq fq_zero() {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
  return r;
}

CC_HD Fq fq_one_mont() {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = one_limb(i);
  return r;
}

CC_HD Proj proj_infinity() { return Proj{fq_zero(), fq_one_mont(), fq_zero()}; }

// a if a < q else a - q, for a < 2q (and a < 2^384)
CC_HD Fq fq_reduce_once(const Fq& a) {
  Fq d;
  Carry c;
  d.v[0] = sub_cc(c, a.v[0], q_limb(0));
#pragma unroll
  for (int i = 1; i < NL; ++i) d.v[i] = subc_cc(c, a.v[i], q_limb(i));
  uint32_t lt = subc(c, 0, 0);  // all ones when a < q
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = lt ? a.v[i] : d.v[i];
  return d;
}

// (a + b) mod q.  a + b < 2q < 2^382: no carry leaves the top limb.
CC_HD Fq fq_add(const Fq& a, const Fq& b) {
  Fq s;
  Carry c;
  s.v[0] = add_cc(c, a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) s.v[i] = addc_cc(c, a.v[i], b.v[i]);
  s.v[NL - 1] = addc(c, a.v[NL - 1], b.v[NL - 1]);
  return fq_reduce_once(s);
}

// (a - b) mod q: the difference, plus q where it borrowed
CC_HD Fq fq_sub(const Fq& a, const Fq& b) {
  Fq d;
  Carry c;
  d.v[0] = sub_cc(c, a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < NL; ++i) d.v[i] = subc_cc(c, a.v[i], b.v[i]);
  uint32_t mask = subc(c, 0, 0);  // all ones when a < b
  Carry k;
  d.v[0] = add_cc(k, d.v[0], q_limb(0) & mask);
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) d.v[i] = addc_cc(k, d.v[i], q_limb(i) & mask);
  d.v[NL - 1] = addc(k, d.v[NL - 1], q_limb(NL - 1) & mask);
  return d;
}

// a * b * 2^-384 mod q (CIOS), inputs < q, output canonical.
//
// The running sum T is kept in two halves, T = ev + 2^32 od + p.  ev takes
// the products of the even limbs of a (and of q) at their own words, od the
// products of the odd limbs one word up, so every product lands in a pair of
// words (2m, 2m+1) of one half: one wide multiply-add with carry (SASS
// IMAD.WIDE.U32.X) whose register pair never straddles the other half's.  A
// row adds a * b_i and m * q (m chosen so that word 0 of T becomes 0), then
// divides by 2^32:
//   T / 2^32 = (od + ev[1]) + 2^32 (ev[2], ..., ev[12]),
// so od becomes the next row's ev, ev shifted down two words its od, and
// ev[1] the word p still to add at word 0; the next row adds p first and
// hands its carry to the od chain, whose first word sits at word 1.
// Bounds: T < 2q between rows and T < q * 2^33 < 2^414 inside one (a < q,
// b_i and m below 2^32); od <= T / 2^32 < 2^382 never carries out of its 12
// words, ev out of its 13.
CC_HD Fq fq_mul(const Fq& a, const Fq& b) {
  uint32_t ev[NL + 1], od[NL], p = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) ev[k] = od[k] = 0;
  ev[NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t bi = b.v[i];
    // T += a * b_i: the pending word, the odd limbs, then the even limbs
    Carry c1;
    ev[0] = add_cc(c1, ev[0], p);
#pragma unroll
    for (int m = 0; m < NL / 2; ++m) {
      od[2 * m] = madc_lo_cc(c1, a.v[2 * m + 1], bi, od[2 * m]);
      od[2 * m + 1] = m < NL / 2 - 1
                          ? madc_hi_cc(c1, a.v[2 * m + 1], bi, od[2 * m + 1])
                          : madc_hi(c1, a.v[2 * m + 1], bi, od[2 * m + 1]);
    }
    Carry c2;
#pragma unroll
    for (int m = 0; m < NL / 2; ++m) {
      ev[2 * m] = m == 0 ? mad_lo_cc(c2, a.v[0], bi, ev[0])
                         : madc_lo_cc(c2, a.v[2 * m], bi, ev[2 * m]);
      ev[2 * m + 1] = madc_hi_cc(c2, a.v[2 * m], bi, ev[2 * m + 1]);
    }
    ev[NL] = addc(c2, ev[NL], 0);
    // T += m * q, which clears word 0
    const uint32_t mi = ev[0] * N0;
    Carry c3;
#pragma unroll
    for (int m = 0; m < NL / 2; ++m) {
      od[2 * m] = m == 0 ? mad_lo_cc(c3, q_limb(1), mi, od[0])
                         : madc_lo_cc(c3, q_limb(2 * m + 1), mi, od[2 * m]);
      od[2 * m + 1] = m < NL / 2 - 1
                          ? madc_hi_cc(c3, q_limb(2 * m + 1), mi, od[2 * m + 1])
                          : madc_hi(c3, q_limb(2 * m + 1), mi, od[2 * m + 1]);
    }
    Carry c4;
#pragma unroll
    for (int m = 0; m < NL / 2; ++m) {
      ev[2 * m] = m == 0 ? mad_lo_cc(c4, q_limb(0), mi, ev[0])
                         : madc_lo_cc(c4, q_limb(2 * m), mi, ev[2 * m]);
      ev[2 * m + 1] = madc_hi_cc(c4, q_limb(2 * m), mi, ev[2 * m + 1]);
    }
    ev[NL] = addc(c4, ev[NL], 0);
    // divide by 2^32: the halves trade places
    p = ev[1];
    uint32_t shifted[NL];
#pragma unroll
    for (int k = 0; k < NL - 1; ++k) shifted[k] = ev[k + 2];
    shifted[NL - 1] = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      ev[k] = od[k];
      od[k] = shifted[k];
    }
    ev[NL] = 0;
  }
  // T = ev + p + 2^32 od < 2q: ev[12] and od[11] are 0
  Fq r;
  Carry c;
  r.v[0] = add_cc(c, ev[0], p);
#pragma unroll
  for (int k = 1; k < NL - 1; ++k) r.v[k] = addc_cc(c, ev[k], od[k - 1]);
  r.v[NL - 1] = addc(c, ev[NL - 1], od[NL - 2]);
  return fq_reduce_once(r);
}

// a * 3b = a * 12 through four modular adds (8a + 4a), as the TPU kernels do
CC_HD Fq fq_mul_b3(const Fq& a) {
  Fq a2 = fq_add(a, a);
  Fq a4 = fq_add(a2, a2);
  Fq a8 = fq_add(a4, a4);
  return fq_add(a8, a4);
}

// Complete mixed addition P + (x2, y2), the second point affine (RCB16
// algorithm 8, a = 0): 11 field multiplies in the sequence of the JAX
// package's `_k_g1_madd`, so the output is the same projective
// representative.  (x2, y2) is a curve point, never infinity.
CC_HD Proj g1_madd(const Proj& p, const Fq& x2, const Fq& y2) {
  Fq t0 = fq_mul(p.x, x2);
  Fq t1 = fq_mul(p.y, y2);
  Fq t3 = fq_mul(fq_add(x2, y2), fq_add(p.x, p.y));
  t3 = fq_sub(t3, fq_add(t0, t1));
  Fq t4 = fq_add(fq_mul(y2, p.z), p.y);
  Fq y3 = fq_add(fq_mul(x2, p.z), p.x);
  Fq x3 = fq_add(t0, t0);
  t0 = fq_add(x3, t0);
  Fq t2 = fq_mul_b3(p.z);
  Fq z3 = fq_add(t1, t2);
  t1 = fq_sub(t1, t2);
  y3 = fq_mul_b3(y3);
  Proj r;
  r.x = fq_sub(fq_mul(t3, t1), fq_mul(t4, y3));
  r.y = fq_add(fq_mul(y3, t0), fq_mul(t1, z3));
  r.z = fq_add(fq_mul(z3, t4), fq_mul(t0, t3));
  return r;
}

// Complete addition P + Q (RCB16 algorithm 7, a = 0): 12 field multiplies in
// the sequence of the JAX package's `_k_g1_add`, so the output is the same
// projective representative.  Any
// canonical inputs, infinity (0 : y : 0) and the all-zero (0, 0, 0) rows of
// the reference's padding included; t0, t1, t2, t3, t4 and x3 are six
// independent products.
CC_HD Proj g1_add(const Proj& p, const Proj& q) {
  Fq t0 = fq_mul(p.x, q.x);
  Fq t1 = fq_mul(p.y, q.y);
  Fq t2 = fq_mul(p.z, q.z);
  Fq t3 = fq_mul(fq_add(p.x, p.y), fq_add(q.x, q.y));
  t3 = fq_sub(t3, fq_add(t0, t1));
  Fq t4 = fq_mul(fq_add(p.y, p.z), fq_add(q.y, q.z));
  t4 = fq_sub(t4, fq_add(t1, t2));
  Fq x3 = fq_mul(fq_add(p.x, p.z), fq_add(q.x, q.z));
  Fq y3 = fq_sub(x3, fq_add(t0, t2));
  x3 = fq_add(t0, t0);
  t0 = fq_add(x3, t0);
  t2 = fq_mul_b3(t2);
  Fq z3 = fq_add(t1, t2);
  t1 = fq_sub(t1, t2);
  y3 = fq_mul_b3(y3);
  Proj r;
  r.x = fq_sub(fq_mul(t3, t1), fq_mul(t4, y3));
  r.y = fq_add(fq_mul(y3, t0), fq_mul(t1, z3));
  r.z = fq_add(fq_mul(z3, t4), fq_mul(t0, t3));
  return r;
}

// Complete doubling (RCB16 algorithm 9, a = 0): 8 field multiplies in the
// sequence of the port's `g1_ops.g1_double` (the JAX package's `g1_double`),
// 3b * t2 by four adds as in the adds above, so the output is the same
// projective representative.  Canonical inputs give canonical outputs (every
// step reduces fully), which `g1_add` needs; infinity (0 : 1 : 0) doubles to
// itself word for word.
CC_HD Proj g1_double(const Proj& p) {
  Fq t0 = fq_mul(p.y, p.y);
  Fq z3 = fq_add(t0, t0);
  z3 = fq_add(z3, z3);
  z3 = fq_add(z3, z3);
  Fq t1 = fq_mul(p.y, p.z);
  Fq t2 = fq_mul_b3(fq_mul(p.z, p.z));
  Fq x3 = fq_mul(t2, z3);
  Fq y3 = fq_add(t0, t2);
  z3 = fq_mul(t1, z3);
  t1 = fq_add(t2, t2);
  t2 = fq_add(t1, t2);
  t0 = fq_sub(t0, t2);
  y3 = fq_add(x3, fq_mul(t0, y3));
  x3 = fq_mul(t0, fq_mul(p.x, p.y));
  Proj r;
  r.x = fq_add(x3, x3);
  r.y = y3;
  r.z = z3;
  return r;
}

// --- the reference layouts at a kernel's boundary ----------------------------
//
// A coordinate is 24 rows of 16-bit limbs ([24, stride], one lane per
// column: neighbouring lanes read neighbouring words), a resident base
// coordinate 12 rows of packed limb pairs ([12, stride]).

CC_HD Fq load16(const uint32_t* rows, int64_t stride, int64_t lane) {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = rows[(2 * i) * stride + lane] |
             (rows[(2 * i + 1) * stride + lane] << 16);
  return r;
}

CC_HD void store16(uint32_t* rows, int64_t stride, int64_t lane, const Fq& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    rows[(2 * i) * stride + lane] = a.v[i] & 0xffffu;
    rows[(2 * i + 1) * stride + lane] = a.v[i] >> 16;
  }
}

CC_HD Fq load_pairs(const uint32_t* rows, int64_t stride, int64_t lane) {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = rows[i * stride + lane];
  return r;
}

}  // namespace cc
