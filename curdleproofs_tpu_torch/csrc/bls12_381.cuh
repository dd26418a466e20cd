// BLS12-381 base field and G1 arithmetic of the first Hopper kernels, now
// serving only g1_fold_packed.cu and g1_fold_rows.cu (the other kernels run
// on the carry-chain core fq_cc.cuh).
//
// One thread owns one field element (or point) at a time.  A field element is
// 12 x 32-bit limbs (little-endian) in Montgomery form with R = 2^384: the
// same radix as the JAX package's 24 x 16-bit limbs (ops/field.py), so every
// residue is identical and a 32-bit limb here is exactly one packed limb pair
// of the resident-bases layout (_pack_rows).  Every function keeps its output
// canonical (< q), so results compare with array equality.
//
// At the kernel boundary tensors keep the reference layouts: a coordinate is
// 24 rows of 16-bit limbs ([24, N], one lane per column), a resident base is
// 12 rows of packed pairs ([12, N]); load_rows16/store_rows16 convert.
//
// Cost: a Montgomery product is a CIOS loop of 144 + 12 + 144 = 300
// 32x32->64 multiplies (IMAD.WIDE, two 32-bit multiply slots each), so the
// kernels built on it are bound by the integer-multiply rate, not by bytes.
#pragma once

#include <stdint.h>

#define CP_DEV __device__ __forceinline__

namespace cp {

constexpr int NL = 12;  // 32-bit limbs per field element

// q, R mod q (Montgomery one) and -q^-1 mod 2^32
__constant__ const uint32_t Q[NL] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ const uint32_t ONE_MONT[NL] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
constexpr uint32_t N0 = 0xfffcfffdu;

struct Fq {
  uint32_t v[NL];
};

struct Proj {  // homogeneous projective (X : Y : Z); infinity is (0 : 1 : 0)
  Fq x, y, z;
};

CP_DEV Fq fq_zero() {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
  return r;
}

CP_DEV Fq fq_one_mont() {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = ONE_MONT[i];
  return r;
}

CP_DEV Proj proj_infinity() { return Proj{fq_zero(), fq_one_mont(), fq_zero()}; }

// a - q if a >= q (a < 2q, given with its carry-out bit `hi`), else a
CP_DEV Fq fq_reduce_once(const Fq& a, uint32_t hi) {
  Fq d;
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int64_t t = (int64_t)a.v[i] - Q[i] + borrow;
    d.v[i] = (uint32_t)t;
    borrow = t >> 32;  // 0 or -1
  }
  // a + hi*2^384 >= q  <=>  no borrow out, or the carry bit absorbs it
  bool ge = (borrow + (int64_t)hi) >= 0;
  return ge ? d : a;
}

CP_DEV Fq fq_add(const Fq& a, const Fq& b) {
  Fq s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return fq_reduce_once(s, (uint32_t)c);
}

CP_DEV Fq fq_sub(const Fq& a, const Fq& b) {
  Fq d;
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int64_t t = (int64_t)a.v[i] - b.v[i] + borrow;
    d.v[i] = (uint32_t)t;
    borrow = t >> 32;
  }
  if (borrow) {  // a < b: add q back
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      c += (uint64_t)d.v[i] + Q[i];
      d.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

// a * b * 2^-384 mod q (CIOS).  Inputs < q; output canonical < q.
CP_DEV Fq fq_mul(const Fq& a, const Fq& b) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * N0;
    c = ((uint64_t)t[0] + (uint64_t)m * Q[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += (uint64_t)t[j] + (uint64_t)m * Q[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = t[i];
  return fq_reduce_once(r, t[NL]);  // the CIOS result is < 2q
}

// a * 3b = a * 12 through four modular adds (8a + 4a), as the TPU kernels do
CP_DEV Fq fq_mul_b3(const Fq& a) {
  Fq a2 = fq_add(a, a);
  Fq a4 = fq_add(a2, a2);
  Fq a8 = fq_add(a4, a4);
  return fq_add(a8, a4);
}

// Complete addition, a = 0 (Renes-Costello-Batina 2016, algorithm 7): 12
// field multiplies.  The same operation sequence as the JAX package's
// `_k_g1_add`, so outputs are the same projective representatives.
CP_DEV Proj g1_add(const Proj& p, const Proj& q) {
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

// --- reference layouts -------------------------------------------------------

// element `lane` of a [24, stride] array of 16-bit limbs
CP_DEV Fq load_rows16(const uint32_t* rows, int64_t stride, int64_t lane) {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = rows[(2 * i) * stride + lane] | (rows[(2 * i + 1) * stride + lane] << 16);
  return r;
}

CP_DEV void store_rows16(uint32_t* rows, int64_t stride, int64_t lane, const Fq& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    rows[(2 * i) * stride + lane] = a.v[i] & 0xffffu;
    rows[(2 * i + 1) * stride + lane] = a.v[i] >> 16;
  }
}

// element `lane` of a [12, stride] array of packed limb pairs
CP_DEV Fq load_pairs(const uint32_t* rows, int64_t stride, int64_t lane) {
  Fq r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = rows[i * stride + lane];
  return r;
}

CP_DEV Proj load_point16(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                         int64_t stride, int64_t lane) {
  return Proj{load_rows16(x, stride, lane), load_rows16(y, stride, lane),
              load_rows16(z, stride, lane)};
}

CP_DEV void store_point16(uint32_t* x, uint32_t* y, uint32_t* z, int64_t stride,
                          int64_t lane, const Proj& p) {
  store_rows16(x, stride, lane, p.x);
  store_rows16(y, stride, lane, p.y);
  store_rows16(z, stride, lane, p.z);
}

}  // namespace cp
