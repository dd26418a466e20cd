// Native host runtime for curdleproofs_tpu_torch: BLS12-381 Fq/G1 over 64-bit limbs.
//
// This is the first-party replacement for the reference's native layer
// (arkworks ark-ff/ark-ec with x86 asm, curdleproofs/Cargo.toml:24-25,35):
// Montgomery CIOS multiplication with __int128 accumulation, Jacobian group
// law, windowed scalar multiplication and Pippenger MSM. Exposed as a C ABI
// consumed via ctypes (no pybind11 in this image).
//
// Data layout at the boundary (all little-endian, canonical — not Montgomery):
//   scalar: 32 bytes
//   point (Jacobian): 3 x 48 bytes (x, y, z); z == 0 encodes infinity.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

#include <sched.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---- generated-at-build-time constants (see build.py) ----
#include "constants_generated.h"
#include "ifma52.h"

namespace {
struct G1;  // fwd
void batch_normalize(G1 *pts, size_t n);  // defined with the inversion code
}  // namespace

#if CP_HAVE_IFMA
namespace {
// defined below with the IFMA ladder machinery
void fold_ifma(const uint8_t *left_bytes, const uint8_t *points, uint64_t n,
               const uint8_t *beta48, const uint8_t *k1, int neg1,
               const uint8_t *k2, int neg2, uint8_t *out);
void batch_mul_each_ifma(const uint8_t *left_bytes,
                         const uint8_t *points, uint64_t n,
                         const uint8_t *beta48,
                         const uint8_t *k1s, const uint8_t *negs1,
                         const uint8_t *k2s, const uint8_t *negs2,
                         uint8_t *out);
}  // namespace
#endif
// Provides:
//   static const u64 P[6];        // Fq modulus
//   static const u64 P_INV64;     // -p^{-1} mod 2^64
//   static const u64 R2[6];       // (2^384)^2 mod p
//   static const u64 ONE_MONT[6]; // 2^384 mod p

namespace {

struct Fq {
    u64 l[6];
};

inline bool fq_is_zero(const Fq &a) {
    return !(a.l[0] | a.l[1] | a.l[2] | a.l[3] | a.l[4] | a.l[5]);
}

inline bool fq_geq_p(const Fq &a) {
    for (int i = 5; i >= 0; --i) {
        if (a.l[i] > P[i]) return true;
        if (a.l[i] < P[i]) return false;
    }
    return true;
}

inline void fq_sub_p(Fq &a) {
    u128 borrow = 0;
    for (int i = 0; i < 6; ++i) {
        u128 d = (u128)a.l[i] - P[i] - (u64)borrow;
        a.l[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

inline void fq_add(const Fq &a, const Fq &b, Fq &r) {
    u128 carry = 0;
    for (int i = 0; i < 6; ++i) {
        u128 s = (u128)a.l[i] + b.l[i] + (u64)carry;
        r.l[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || fq_geq_p(r)) fq_sub_p(r);
}

inline void fq_sub(const Fq &a, const Fq &b, Fq &r) {
    u128 borrow = 0;
    for (int i = 0; i < 6; ++i) {
        u128 d = (u128)a.l[i] - b.l[i] - (u64)borrow;
        r.l[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 6; ++i) {
            u128 s = (u128)r.l[i] + P[i] + (u64)carry;
            r.l[i] = (u64)s;
            carry = s >> 64;
        }
    }
}

inline void fq_neg(const Fq &a, Fq &r) {
    if (fq_is_zero(a)) { r = a; return; }
    u128 borrow = 0;
    for (int i = 0; i < 6; ++i) {
        u128 d = (u128)P[i] - a.l[i] - (u64)borrow;
        r.l[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

// Montgomery CIOS product: r = a * b * 2^{-384} mod p
void fq_mul_generic(const Fq &a, const Fq &b, Fq &r) {
    u64 t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 6; ++i) {
        u128 c = 0;
        for (int j = 0; j < 6; ++j) {
            u128 cur = (u128)t[j] + (u128)a.l[j] * b.l[i] + (u64)c;
            t[j] = (u64)cur;
            c = cur >> 64;
        }
        u128 cur = (u128)t[6] + (u64)c;
        t[6] = (u64)cur;
        t[7] = (u64)(cur >> 64);

        u64 m = t[0] * P_INV64;
        c = ((u128)t[0] + (u128)m * P[0]) >> 64;
        for (int j = 1; j < 6; ++j) {
            u128 cur2 = (u128)t[j] + (u128)m * P[j] + (u64)c;
            t[j - 1] = (u64)cur2;
            c = cur2 >> 64;
        }
        cur = (u128)t[6] + (u64)c;
        t[5] = (u64)cur;
        t[6] = t[7] + (u64)(cur >> 64);
    }
    std::memcpy(r.l, t, 48);
    if (t[6] || fq_geq_p(r)) fq_sub_p(r);
}

#if defined(__ADX__) && defined(__BMI2__)
// ADX/BMI2 no-carry CIOS (mulx + dual adcx/adox carry chains). Valid for
// BLS12-381 because P's top limb 0x1a0111ea397fe69a < 2^63 - 1 (the "no-carry"
// bound): the running accumulator never exceeds 7 limbs, so one spare register
// holds the top limb per round. The logical accumulator rotates through the
// six physical registers each round, so the post-round shift is a single mov.
// Measured 52 ns vs 107 ns for the u128 loop on the target Xeon.
void fq_mul_adx(const Fq &A, const Fq &B, Fq &R) {
    u64 t0, t1, t2, t3, t4, t5, hi;
    const u64 *a = A.l, *b = B.l, *p = P;
    u64 pinv = P_INV64;
    __asm__ volatile(
        ".macro MULROUND off, s0, s1, s2, s3, s4, s5\n\t"
        "movq \\off(%[b]), %%rdx\n\t"
        "xorl %%r8d, %%r8d\n\t"
        "mulxq 0(%[a]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s0\n\t"
        "adoxq %%rbx, \\s1\n\t"
        "mulxq 8(%[a]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s1\n\t"
        "adoxq %%rbx, \\s2\n\t"
        "mulxq 16(%[a]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s2\n\t"
        "adoxq %%rbx, \\s3\n\t"
        "mulxq 24(%[a]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s3\n\t"
        "adoxq %%rbx, \\s4\n\t"
        "mulxq 32(%[a]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s4\n\t"
        "adoxq %%rbx, \\s5\n\t"
        "mulxq 40(%[a]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s5\n\t"
        "adoxq %%r8, %%rbx\n\t"
        "adcxq %%r8, %%rbx\n\t"
        "movq %%rbx, %[hi]\n\t"
        "movq \\s0, %%rdx\n\t"
        "imulq %[pinv], %%rdx\n\t"
        "xorl %%r8d, %%r8d\n\t"
        "mulxq 0(%[p]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s0\n\t"
        "adoxq %%rbx, \\s1\n\t"
        "mulxq 8(%[p]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s1\n\t"
        "adoxq %%rbx, \\s2\n\t"
        "mulxq 16(%[p]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s2\n\t"
        "adoxq %%rbx, \\s3\n\t"
        "mulxq 24(%[p]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s3\n\t"
        "adoxq %%rbx, \\s4\n\t"
        "mulxq 32(%[p]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s4\n\t"
        "adoxq %%rbx, \\s5\n\t"
        "mulxq 40(%[p]), %%rax, %%rbx\n\t"
        "adcxq %%rax, \\s5\n\t"
        "adoxq %[hi], %%rbx\n\t"
        "adcxq %%r8, %%rbx\n\t"
        "movq %%rbx, \\s0\n\t"
        ".endm\n\t"
        "xorq %[t0], %[t0]\n\t"
        "xorq %[t1], %[t1]\n\t"
        "xorq %[t2], %[t2]\n\t"
        "xorq %[t3], %[t3]\n\t"
        "xorq %[t4], %[t4]\n\t"
        "xorq %[t5], %[t5]\n\t"
        "MULROUND 0,  %[t0], %[t1], %[t2], %[t3], %[t4], %[t5]\n\t"
        "MULROUND 8,  %[t1], %[t2], %[t3], %[t4], %[t5], %[t0]\n\t"
        "MULROUND 16, %[t2], %[t3], %[t4], %[t5], %[t0], %[t1]\n\t"
        "MULROUND 24, %[t3], %[t4], %[t5], %[t0], %[t1], %[t2]\n\t"
        "MULROUND 32, %[t4], %[t5], %[t0], %[t1], %[t2], %[t3]\n\t"
        "MULROUND 40, %[t5], %[t0], %[t1], %[t2], %[t3], %[t4]\n\t"
        ".purgem MULROUND\n\t"
        : [t0] "=&r"(t0), [t1] "=&r"(t1), [t2] "=&r"(t2),
          [t3] "=&r"(t3), [t4] "=&r"(t4), [t5] "=&r"(t5), [hi] "=&r"(hi)
        // pinv as a memory operand: with the frame pointer kept (the default
        // of some toolchains) the 11 register operands plus 4 clobbers would
        // need every general register
        : [a] "r"(a), [b] "r"(b), [p] "r"(p), [pinv] "m"(pinv)
        : "rax", "rbx", "rdx", "r8", "cc", "memory");
    R.l[0] = t0; R.l[1] = t1; R.l[2] = t2;
    R.l[3] = t3; R.l[4] = t4; R.l[5] = t5;
    if (fq_geq_p(R)) fq_sub_p(R);
}
inline void fq_mul(const Fq &a, const Fq &b, Fq &r) { fq_mul_adx(a, b, r); }
#else
inline void fq_mul(const Fq &a, const Fq &b, Fq &r) { fq_mul_generic(a, b, r); }
#endif

// Dedicated Montgomery squaring (SOS): cross products once + doubled,
// diagonal added, then a separate 6-step reduction. ~25% fewer limb products
// than fq_mul_generic — but slower than the ADX mul, so only used as fallback.
void fq_sqr_generic(const Fq &a, Fq &r) {
    u64 t[13] = {0};
    // cross terms i < j
    for (int i = 0; i < 6; ++i) {
        u128 c = 0;
        for (int j = i + 1; j < 6; ++j) {
            u128 cur = (u128)t[i + j] + (u128)a.l[i] * a.l[j] + (u64)c;
            t[i + j] = (u64)cur;
            c = cur >> 64;
        }
        u128 cur = (u128)t[i + 6] + (u64)c;
        t[i + 6] = (u64)cur;
        // (carry out of t[i+6] impossible: t[i+6] only holds prior carries)
    }
    // double
    u64 top = 0;
    for (int i = 11; i >= 1; --i) {
        t[i] = (t[i] << 1) | (t[i - 1] >> 63);
    }
    t[0] <<= 1;
    // add diagonals
    u128 c = 0;
    for (int i = 0; i < 6; ++i) {
        u128 sq = (u128)a.l[i] * a.l[i];
        u128 lo = (u128)t[2 * i] + (u64)sq + (u64)c;
        t[2 * i] = (u64)lo;
        u128 hi = (u128)t[2 * i + 1] + (u64)(sq >> 64) + (u64)(lo >> 64);
        t[2 * i + 1] = (u64)hi;
        c = hi >> 64;
    }
    t[12] = (u64)c;
    // Montgomery reduction (SOS): clear limbs 0..5
    u64 extra = t[12];
    for (int i = 0; i < 6; ++i) {
        u64 m = t[i] * P_INV64;
        u128 cc = 0;
        for (int j = 0; j < 6; ++j) {
            u128 cur = (u128)t[i + j] + (u128)m * P[j] + (u64)cc;
            t[i + j] = (u64)cur;
            cc = cur >> 64;
        }
        // propagate carry into the higher limbs
        int k = i + 6;
        while (cc && k < 12) {
            u128 cur = (u128)t[k] + (u64)cc;
            t[k] = (u64)cur;
            cc = cur >> 64;
            ++k;
        }
        extra += (u64)cc;
    }
    std::memcpy(r.l, t + 6, 48);
    if (extra || fq_geq_p(r)) fq_sub_p(r);
}

#if defined(__ADX__) && defined(__BMI2__)
inline void fq_sqr(const Fq &a, Fq &r) { fq_mul_adx(a, a, r); }
#else
inline void fq_sqr(const Fq &a, Fq &r) { fq_sqr_generic(a, r); }
#endif

inline void to_mont(Fq &a) {
    Fq r2;
    std::memcpy(r2.l, R2, 48);
    Fq out;
    fq_mul(a, r2, out);
    a = out;
}

inline void from_mont(Fq &a) {
    Fq one = {{1, 0, 0, 0, 0, 0}};
    Fq out;
    fq_mul(a, one, out);
    a = out;
}

inline void fq_dbl(const Fq &a, Fq &r) { fq_add(a, a, r); }

// ---- G1 in Jacobian coordinates (Montgomery-form coordinates) ----

struct G1 {
    Fq x, y, z;  // z == 0 => infinity
};

void g1_set_inf(G1 &p);

inline bool g1_is_inf(const G1 &p) { return fq_is_zero(p.z); }

void g1_double(const G1 &p, G1 &r) {
    if (g1_is_inf(p)) { r = p; return; }
    Fq A, B, C, D, E, F, t0, t1;
    fq_sqr(p.x, A);
    fq_sqr(p.y, B);
    fq_sqr(B, C);
    // D = 2*((X+B)^2 - A - C)
    fq_add(p.x, B, t0);
    fq_sqr(t0, t0);
    fq_sub(t0, A, t0);
    fq_sub(t0, C, t0);
    fq_dbl(t0, D);
    // E = 3A; F = E^2
    fq_dbl(A, E);
    fq_add(E, A, E);
    fq_sqr(E, F);
    // X3 = F - 2D
    fq_dbl(D, t0);
    fq_sub(F, t0, r.x);
    // Y3 = E*(D - X3) - 8C
    fq_sub(D, r.x, t0);
    fq_mul(E, t0, t0);
    fq_dbl(C, t1);
    fq_dbl(t1, t1);
    fq_dbl(t1, t1);
    Fq y3;
    fq_sub(t0, t1, y3);
    // Z3 = 2*Y1*Z1
    Fq z3;
    fq_mul(p.y, p.z, z3);
    fq_dbl(z3, r.z);
    r.y = y3;
}

inline bool fq_is_one_mont(const Fq &a) {
    return std::memcmp(a.l, ONE_MONT, 48) == 0;
}

void g1_add(const G1 &p, const G1 &q, G1 &r) {
    if (g1_is_inf(p)) { r = q; return; }
    if (g1_is_inf(q)) { r = p; return; }
    Fq Z1Z1, Z2Z2, U1, U2, S1, S2, t;
    bool q_affine = fq_is_one_mont(q.z);
    fq_sqr(p.z, Z1Z1);
    if (q_affine) {  // mixed addition: skip 4 muls
        U1 = p.x;
        S1 = p.y;
    } else {
        fq_sqr(q.z, Z2Z2);
        fq_mul(p.x, Z2Z2, U1);
        fq_mul(p.y, q.z, t);
        fq_mul(t, Z2Z2, S1);
    }
    fq_mul(q.x, Z1Z1, U2);
    fq_mul(q.y, p.z, t);
    fq_mul(t, Z1Z1, S2);

    Fq H, I, J, rr, V;
    fq_sub(U2, U1, H);
    if (fq_is_zero(H)) {
        Fq sd;
        fq_sub(S2, S1, sd);
        if (fq_is_zero(sd)) { g1_double(p, r); return; }
        g1_set_inf(r);
        return;
    }
    fq_dbl(H, t);
    fq_sqr(t, I);
    fq_mul(H, I, J);
    fq_sub(S2, S1, rr);
    fq_dbl(rr, rr);
    fq_mul(U1, I, V);
    // X3 = r^2 - J - 2V
    Fq x3;
    fq_sqr(rr, x3);
    fq_sub(x3, J, x3);
    fq_sub(x3, V, x3);
    fq_sub(x3, V, x3);
    // Y3 = r*(V - X3) - 2*S1*J
    Fq y3;
    fq_sub(V, x3, t);
    fq_mul(rr, t, y3);
    fq_mul(S1, J, t);
    fq_dbl(t, t);
    fq_sub(y3, t, y3);
    // Z3 = 2*Z1*Z2*H  (note: ((Z1+Z2)^2 - Z1Z1 - Z2Z2)*H / 2... use direct)
    Fq z3;
    fq_mul(p.z, q.z, z3);
    fq_mul(z3, H, z3);
    fq_dbl(z3, z3);
    r.x = x3; r.y = y3; r.z = z3;
}

void g1_set_inf(G1 &p) {
    std::memset(&p, 0, sizeof(G1));
    std::memcpy(p.y.l, ONE_MONT, 48);
}

// scalar given as 32 LE bytes (canonical)
void g1_mul(const G1 &p, const uint8_t *scalar, G1 &r) {
    g1_set_inf(r);
    bool started = false;
    for (int byte = 31; byte >= 0; --byte) {
        for (int bit = 7; bit >= 0; --bit) {
            if (started) g1_double(r, r);
            if ((scalar[byte] >> bit) & 1) {
                if (started) {
                    G1 t;
                    g1_add(r, p, t);
                    r = t;
                } else {
                    r = p;
                    started = true;
                }
            }
        }
    }
}

// ---- boundary codecs ----

void load_fq(const uint8_t *in, Fq &out) {
    std::memcpy(out.l, in, 48);
    to_mont(out);
}

void store_fq(const Fq &in, uint8_t *out) {
    Fq t = in;
    from_mont(t);
    std::memcpy(out, t.l, 48);
}

void load_g1(const uint8_t *in, G1 &out) {
    load_fq(in, out.x);
    load_fq(in + 48, out.y);
    load_fq(in + 96, out.z);
}

void store_g1(const G1 &in, uint8_t *out) {
    store_fq(in.x, out);
    store_fq(in.y, out + 48);
    store_fq(in.z, out + 96);
}

// ---- Pippenger MSM ----

int pick_window(size_t n) {
    if (n < 32) return 3;
    int c = 1;
    size_t v = n;
    while (v >>= 1) ++c;      // ~log2(n)
    c = c > 3 ? c - 2 : 3;    // log2(n) - 2 heuristic (arkworks-like)
    return c > 13 ? 13 : c;
}

static inline unsigned extract_digit(const uint8_t *s, int bit_lo, int c) {
    unsigned digit = 0;
    for (int k = 0; k < c; ++k) {
        int bit = bit_lo + k;
        if (bit >= 256) break;
        digit |= (((s[bit >> 3] >> (bit & 7)) & 1u) << k);
    }
    return digit;
}

// Straus interleaved MSM: one shared doubling chain, per-point 4-bit tables.
// Wins for small n (the protocol's sub-argument MSMs are n = logn .. 2n).
void msm_straus(const G1 *pts, const uint8_t *scalars, size_t n, G1 &out) {
    const int C = 4;
    const int DIGITS = (255 + C - 1) / C;  // 64
    std::vector<G1> table(n * 15);         // table[i][d-1] = d * P_i
    for (size_t i = 0; i < n; ++i) {
        G1 *t = &table[i * 15];
        t[0] = pts[i];
        for (int d = 2; d <= 15; ++d) {
            if (d % 2 == 0) g1_double(t[d / 2 - 1], t[d - 1]);
            else g1_add(t[d - 2], pts[i], t[d - 1]);
        }
    }
    g1_set_inf(out);
    for (int w = DIGITS - 1; w >= 0; --w) {
        for (int k = 0; k < C; ++k) g1_double(out, out);
        for (size_t i = 0; i < n; ++i) {
            unsigned digit = extract_digit(scalars + 32 * i, w * C, C);
            if (digit) {
                G1 t;
                g1_add(out, table[i * 15 + digit - 1], t);
                out = t;
            }
        }
    }
}

void msm_impl(const G1 *pts, const uint8_t *scalars, size_t n, G1 &out) {
    const int NB = 255;
    if (n <= 48) { msm_straus(pts, scalars, n, out); return; }
    int c = pick_window(n);
    int windows = (NB + c - 1) / c;
    std::vector<G1> buckets((size_t)1 << c);

    g1_set_inf(out);
    for (int w = windows - 1; w >= 0; --w) {
        for (int k = 0; k < c; ++k) g1_double(out, out);
        size_t nb = (size_t)1 << c;
        size_t max_bucket = 0;
        for (size_t b = 0; b < nb; ++b) g1_set_inf(buckets[b]);
        int bit_lo = w * c;
        for (size_t i = 0; i < n; ++i) {
            unsigned digit = extract_digit(scalars + 32 * i, bit_lo, c);
            if (digit) {
                G1 t;
                g1_add(buckets[digit], pts[i], t);
                buckets[digit] = t;
                if (digit > max_bucket) max_bucket = digit;
            }
        }
        if (!max_bucket) continue;
        G1 running, wsum, t;
        g1_set_inf(running);
        g1_set_inf(wsum);
        for (size_t b = max_bucket; b >= 1; --b) {
            g1_add(running, buckets[b], t);
            running = t;
            g1_add(wsum, running, t);
            wsum = t;
        }
        g1_add(out, wsum, t);
        out = t;
    }
}

}  // namespace

extern "C" {

// points: n * 144 bytes (Jacobian canonical LE); scalars: n * 32 bytes; out: 144
void cp_msm(const uint8_t *points, const uint8_t *scalars, uint64_t n,
            uint8_t *out) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, pts[i]);
    G1 r;
    msm_impl(pts.data(), scalars, n, r);
    store_g1(r, out);
}

void cp_add(const uint8_t *p, const uint8_t *q, uint8_t *out) {
    G1 a, b, r;
    load_g1(p, a);
    load_g1(q, b);
    g1_add(a, b, r);
    store_g1(r, out);
}

void cp_mul(const uint8_t *p, const uint8_t *scalar, uint8_t *out) {
    G1 a, r;
    load_g1(p, a);
    g1_mul(a, scalar, r);
    store_g1(r, out);
}

// out: n * 144
void cp_batch_mul(const uint8_t *points, uint64_t n, const uint8_t *scalar,
                  uint8_t *out) {
    for (uint64_t i = 0; i < n; ++i) {
        G1 a, r;
        load_g1(points + 144 * i, a);
        g1_mul(a, scalar, r);
        store_g1(r, out + 144 * i);
    }
}

void cp_batch_mul_each(const uint8_t *points, const uint8_t *scalars,
                       uint64_t n, uint8_t *out) {
    for (uint64_t i = 0; i < n; ++i) {
        G1 a, r;
        load_g1(points + 144 * i, a);
        g1_mul(a, scalars + 32 * i, r);
        store_g1(r, out + 144 * i);
    }
}

// left/right: n*144; out[i] = left[i] + gamma*right[i]
void cp_fold(const uint8_t *left, const uint8_t *right, uint64_t n,
             const uint8_t *gamma, uint8_t *out) {
    for (uint64_t i = 0; i < n; ++i) {
        G1 l, rp, m, r;
        load_g1(left + 144 * i, l);
        load_g1(right + 144 * i, rp);
        g1_mul(rp, gamma, m);
        g1_add(l, m, r);
        store_g1(r, out + 144 * i);
    }
}

}  // extern "C"

// ---- Keccak-f[1600] (STROBE/Merlin transcript hot loop) ----

extern "C" {

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int KECCAK_ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                   25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

static inline u64 rotl64(u64 v, int n) {
    if (n == 0) return v;
    return (v << n) | (v >> (64 - n));
}

// state: 200 bytes, lanes little-endian (in-place)
void cp_keccak_f1600(uint8_t *state) {
    u64 a[25];
    std::memcpy(a, state, 200);
    for (int round = 0; round < 24; ++round) {
        u64 c[5], d[5];
        for (int x = 0; x < 5; ++x)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; ++x)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
        u64 b[25];
        for (int x = 0; x < 5; ++x)
            for (int y = 0; y < 5; ++y)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], KECCAK_ROT[x + 5 * y]);
        for (int y = 0; y < 5; ++y)
            for (int x = 0; x < 5; ++x)
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
        a[0] ^= KECCAK_RC[round];
    }
    std::memcpy(state, a, 200);
}

// Raw (unreduced) scalar multiplication; scalar_len bytes little-endian.
void cp_mul_raw(const uint8_t *p, const uint8_t *scalar, uint64_t scalar_len,
                uint8_t *out) {
    G1 a, r;
    load_g1(p, a);
    g1_set_inf(r);
    bool started = false;
    for (int64_t byte = (int64_t)scalar_len - 1; byte >= 0; --byte) {
        for (int bit = 7; bit >= 0; --bit) {
            if (started) g1_double(r, r);
            if ((scalar[byte] >> bit) & 1) {
                if (started) {
                    G1 t;
                    g1_add(r, a, t);
                    r = t;
                } else {
                    r = a;
                    started = true;
                }
            }
        }
    }
    store_g1(r, out);
}

}  // extern "C"

// ---- GLV dual-scalar multiplication ----
// out[i] = (left ? left[i] : 0) + k1*P_i + k2*phi(P_i), phi = (beta*x, y, z)
// k1/k2: |value| as 32-byte LE + sign flags; nbits bounds both bit lengths.

namespace {

void g1_neg_inplace(G1 &p) {
    if (!g1_is_inf(p)) fq_neg(p.y, p.y);
}

void build_table15(const G1 &p, G1 *t) {  // t[d-1] = d*p, d = 1..15
    t[0] = p;
    for (int d = 2; d <= 15; ++d) {
        if (d % 2 == 0) g1_double(t[d / 2 - 1], t[d - 1]);
        else g1_add(t[d - 2], p, t[d - 1]);
    }
}

void dual_mul_core(const G1 &base, const Fq &beta_mont,
                   const uint8_t *k1, int neg1,
                   const uint8_t *k2, int neg2, int nbits,
                   const G1 *left, G1 &out) {
    G1 r1 = base;
    if (neg1) g1_neg_inplace(r1);
    G1 r2 = base;
    fq_mul(r2.x, beta_mont, r2.x);
    if (neg2) g1_neg_inplace(r2);

    G1 t1[15], t2[15];
    build_table15(r1, t1);
    build_table15(r2, t2);

    const int C = 4;
    int windows = (nbits + C - 1) / C;
    G1 acc;
    g1_set_inf(acc);
    G1 tmp;
    for (int w = windows - 1; w >= 0; --w) {
        for (int k = 0; k < C; ++k) g1_double(acc, acc);
        unsigned d1 = extract_digit(k1, w * C, C);
        unsigned d2 = extract_digit(k2, w * C, C);
        if (d1) { g1_add(acc, t1[d1 - 1], tmp); acc = tmp; }
        if (d2) { g1_add(acc, t2[d2 - 1], tmp); acc = tmp; }
    }
    if (left) { g1_add(acc, *left, tmp); acc = tmp; }
    out = acc;
}

}  // namespace

extern "C" {

// mode: 0 = batch_mul (same k for all points, no left)
//       1 = fold (left provided)
void cp_dual_mul(const uint8_t *left_bytes, const uint8_t *points,
                 uint64_t n, const uint8_t *beta48,
                 const uint8_t *k1, int32_t neg1,
                 const uint8_t *k2, int32_t neg2, int32_t nbits,
                 uint8_t *out) {
    Fq beta;
    load_fq(beta48, beta);
    for (uint64_t i = 0; i < n; ++i) {
        G1 base, l, r;
        load_g1(points + 144 * i, base);
        if (left_bytes) load_g1(left_bytes + 144 * i, l);
        dual_mul_core(base, beta, k1, neg1, k2, neg2, nbits,
                      left_bytes ? &l : nullptr, r);
        store_g1(r, out + 144 * i);
    }
}

// per-point scalars, pre-decomposed: k1s/k2s are n*32 bytes, negs are n int8
void cp_dual_mul_each(const uint8_t *points, uint64_t n,
                      const uint8_t *beta48,
                      const uint8_t *k1s, const int8_t *negs1,
                      const uint8_t *k2s, const int8_t *negs2,
                      int32_t nbits, uint8_t *out) {
#if CP_HAVE_IFMA
    if (nbits <= 128 && n >= 4 && !std::getenv("CP_NO_IFMA")) {
        batch_mul_each_ifma(nullptr, points, n, beta48, k1s,
                            (const uint8_t *)negs1, k2s,
                            (const uint8_t *)negs2, out);
        return;
    }
#endif
    Fq beta;
    load_fq(beta48, beta);
    for (uint64_t i = 0; i < n; ++i) {
        G1 base, r;
        load_g1(points + 144 * i, base);
        dual_mul_core(base, beta, k1s + 32 * i, negs1[i], k2s + 32 * i,
                      negs2[i], nbits, nullptr, r);
        store_g1(r, out + 144 * i);
    }
}

// out[i] = left[i] + k_i * P_i with per-point scalars (the IPA verifier-side
// fold pair gamma/gamma_inv runs as one call over G || G').
void cp_fold_each(const uint8_t *left, const uint8_t *points, uint64_t n,
                  const uint8_t *beta48,
                  const uint8_t *k1s, const int8_t *negs1,
                  const uint8_t *k2s, const int8_t *negs2,
                  int32_t nbits, uint8_t *out) {
#if CP_HAVE_IFMA
    if (nbits <= 128 && n >= 4 && !std::getenv("CP_NO_IFMA")) {
        batch_mul_each_ifma(left, points, n, beta48, k1s,
                            (const uint8_t *)negs1, k2s,
                            (const uint8_t *)negs2, out);
        return;
    }
#endif
    Fq beta;
    load_fq(beta48, beta);
    std::vector<G1> res(n);
    for (uint64_t i = 0; i < n; ++i) {
        G1 base, l;
        load_g1(points + 144 * i, base);
        load_g1(left + 144 * i, l);
        dual_mul_core(base, beta, k1s + 32 * i, negs1[i], k2s + 32 * i,
                      negs2[i], nbits, &l, res[i]);
    }
    batch_normalize(res.data(), n);
    for (uint64_t i = 0; i < n; ++i) store_g1(res[i], out + 144 * i);
}

}  // extern "C"

// ---- batch normalisation (Montgomery batch inversion, Fermat base case) ----

namespace {

// r = a^(p-2) mod p (Montgomery domain), square-and-multiply
void fq_inv(const Fq &a, Fq &r) {
    // exponent p-2, big-endian bit scan
    u64 e[6];
    std::memcpy(e, P, 48);
    // subtract 2
    if (e[0] >= 2) { e[0] -= 2; }
    else { e[0] -= 2; /* borrow */ for (int i = 1; i < 6; ++i) { if (e[i]--) break; } }
    Fq acc;
    std::memcpy(acc.l, ONE_MONT, 48);
    bool started = false;
    for (int limb = 5; limb >= 0; --limb) {
        for (int bit = 63; bit >= 0; --bit) {
            if (started) fq_sqr(acc, acc);
            if ((e[limb] >> bit) & 1) {
                if (started) fq_mul(acc, a, acc);
                else { acc = a; started = true; }
            }
        }
    }
    r = acc;
}

// normalise n Jacobian points to z in {0, 1(mont)} with ONE field inversion
void batch_normalize(G1 *pts, size_t n) {
    if (!n) return;
    std::vector<Fq> prefix(n);
    Fq acc;
    std::memcpy(acc.l, ONE_MONT, 48);
    for (size_t i = 0; i < n; ++i) {
        prefix[i] = acc;
        if (!fq_is_zero(pts[i].z)) fq_mul(acc, pts[i].z, acc);
    }
    Fq inv;
    fq_inv(acc, inv);
    for (size_t i = n; i-- > 0;) {
        if (fq_is_zero(pts[i].z)) continue;
        Fq zinv;
        fq_mul(inv, prefix[i], zinv);      // 1/z_i
        fq_mul(inv, pts[i].z, inv);        // strip z_i from the running inverse
        Fq zinv2, zinv3;
        fq_sqr(zinv, zinv2);
        fq_mul(zinv2, zinv, zinv3);
        fq_mul(pts[i].x, zinv2, pts[i].x);
        fq_mul(pts[i].y, zinv3, pts[i].y);
        std::memcpy(pts[i].z.l, ONE_MONT, 48);
    }
}

}  // namespace

extern "C" {

void cp_batch_normalize(uint8_t *points_inout, uint64_t n) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points_inout + 144 * i, pts[i]);
    batch_normalize(pts.data(), n);
    for (uint64_t i = 0; i < n; ++i) store_g1(pts[i], points_inout + 144 * i);
}

// Export n Jacobian points as affine MONTGOMERY-form limb blocks for the
// device MSM upload path: out_x/out_y get 48 LE bytes per point of the raw
// Montgomery residue (host R = 2^384 = the device limb radix^24, so the
// residues transfer without any form change), out_zb one liveness byte.
// Skips the two from_mont muls per coordinate that store_g1 would pay and
// lets the device skip its to-Montgomery multiply entirely.
void cp_export_mont_affine(const uint8_t *points, uint64_t n,
                           uint8_t *out_x, uint8_t *out_y, uint8_t *out_zb) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, pts[i]);
    batch_normalize(pts.data(), n);
    for (uint64_t i = 0; i < n; ++i) {
        if (g1_is_inf(pts[i])) {
            // canonical identity (0 : 1 : 0) — the complete-add formulas
            // require this exact representation, whatever x/y the host
            // object carried
            std::memset(out_x + 48 * i, 0, 48);
            std::memcpy(out_y + 48 * i, ONE_MONT, 48);
            out_zb[i] = 0;
        } else {
            std::memcpy(out_x + 48 * i, pts[i].x.l, 48);
            std::memcpy(out_y + 48 * i, pts[i].y.l, 48);
            out_zb[i] = 1;
        }
    }
}

// Compressed device upload: affine MONTGOMERY x plus ONE metadata byte per
// point (bit0 = liveness, bit1 = canonical-y parity).  The device rebuilds
// y with the sqrt kernel (ops/pallas_kernels.py g1_sqrt), so the slow
// host->device link carries 48+1 bytes per point instead of 96+1.
void cp_export_mont_x(const uint8_t *points, uint64_t n,
                      uint8_t *out_x, uint8_t *out_meta) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, pts[i]);
    batch_normalize(pts.data(), n);
    for (uint64_t i = 0; i < n; ++i) {
        if (g1_is_inf(pts[i])) {
            std::memset(out_x + 48 * i, 0, 48);
            out_meta[i] = 0;
        } else {
            std::memcpy(out_x + 48 * i, pts[i].x.l, 48);
            Fq y = pts[i].y;
            from_mont(y);
            out_meta[i] = (uint8_t)(1u | ((y.l[0] & 1u) << 1));
        }
    }
}

// fold with normalised output: out[i] = left[i] + k1*R_i + k2*phi(R_i), z=1
void cp_dual_mul_norm(const uint8_t *left_bytes, const uint8_t *points,
                      uint64_t n, const uint8_t *beta48,
                      const uint8_t *k1, int32_t neg1,
                      const uint8_t *k2, int32_t neg2, int32_t nbits,
                      uint8_t *out) {
#if CP_HAVE_IFMA
    if (nbits <= 128 && n >= 4 && !std::getenv("CP_NO_IFMA")) {
        fold_ifma(left_bytes, points, n, beta48, k1, neg1, k2, neg2, out);
        return;
    }
#endif
    Fq beta;
    load_fq(beta48, beta);
    std::vector<G1> res(n);
    for (uint64_t i = 0; i < n; ++i) {
        G1 base, l;
        load_g1(points + 144 * i, base);
        if (left_bytes) load_g1(left_bytes + 144 * i, l);
        dual_mul_core(base, beta, k1, neg1, k2, neg2, nbits,
                      left_bytes ? &l : nullptr, res[i]);
    }
    batch_normalize(res.data(), n);
    for (uint64_t i = 0; i < n; ++i) store_g1(res[i], out + 144 * i);
}

}  // extern "C"

// ---- batch-affine Pippenger MSM ----
// Bucket accumulation with affine additions and shared batch inversion:
// per added point ~6M instead of ~16M. Scheduling: passes over the t-th
// occupant of every (window, bucket) — all additions in a pass touch
// distinct buckets, and the pass's inversions are batched across ALL windows.

namespace {

struct AffPt {
    Fq x, y;
    bool inf;
};

// batched affine bucket += (+-)point; pairs are (bucket slot, point) with
// distinct slots. Handles assign/double/cancel cases. `negs` (nullable) flips
// the sign of the incoming point per entry (signed-digit / GLV support).
void affine_add_pass(AffPt *buckets, const int64_t *slots,
                     const AffPt *pts, const int64_t *pis, size_t m,
                     std::vector<Fq> &denoms, std::vector<int> &kinds,
                     const uint8_t *negs = nullptr) {
    denoms.clear();
    kinds.assign(m, 0);  // 0 = no-op/assign, 1 = add, 2 = double
    // first sweep: classify, collect denominators
    for (size_t i = 0; i < m; ++i) {
        AffPt &b = buckets[slots[i]];
        const AffPt &p = pts[pis[i]];
        if (p.inf) { kinds[i] = 0; continue; }
        if (b.inf) { kinds[i] = 3; continue; }  // assign
        Fq py = p.y;
        if (negs && negs[i]) fq_neg(p.y, py);
        if (std::memcmp(b.x.l, p.x.l, 48) == 0) {
            if (std::memcmp(b.y.l, py.l, 48) == 0) {
                kinds[i] = 2;  // double: denom = 2y
                Fq d;
                fq_dbl(b.y, d);
                denoms.push_back(d);
            } else {
                kinds[i] = 4;  // cancel to infinity
            }
        } else {
            kinds[i] = 1;      // add: denom = x2 - x1
            Fq d;
            fq_sub(p.x, b.x, d);
            denoms.push_back(d);
        }
    }
    // batch invert denominators (Montgomery's trick)
    size_t nd = denoms.size();
    if (nd) {
        std::vector<Fq> prefix(nd);
        Fq acc;
        std::memcpy(acc.l, ONE_MONT, 48);
        for (size_t i = 0; i < nd; ++i) {
            prefix[i] = acc;
            fq_mul(acc, denoms[i], acc);
        }
        Fq inv;
        fq_inv(acc, inv);
        for (size_t i = nd; i-- > 0;) {
            Fq di;
            fq_mul(inv, prefix[i], di);
            fq_mul(inv, denoms[i], inv);
            denoms[i] = di;  // now the inverse
        }
    }
    // second sweep: apply
    size_t di = 0;
    for (size_t i = 0; i < m; ++i) {
        AffPt &b = buckets[slots[i]];
        const AffPt &p = pts[pis[i]];
        Fq py = p.y;
        if (negs && negs[i] && !p.inf) fq_neg(p.y, py);
        switch (kinds[i]) {
            case 0: break;
            case 3: b.x = p.x; b.y = py; b.inf = false; break;
            case 4: b.inf = true; break;
            case 1: {  // affine add
                Fq lam, t;
                fq_sub(py, b.y, t);
                fq_mul(t, denoms[di++], lam);
                Fq x3, y3;
                fq_sqr(lam, x3);
                fq_sub(x3, b.x, x3);
                fq_sub(x3, p.x, x3);
                fq_sub(b.x, x3, t);
                fq_mul(lam, t, y3);
                fq_sub(y3, b.y, y3);
                b.x = x3;
                b.y = y3;
                break;
            }
            case 2: {  // affine double: lam = 3x^2 / 2y (a = 0)
                Fq lam, t;
                fq_sqr(b.x, t);
                Fq t3;
                fq_dbl(t, t3);
                fq_add(t3, t, t3);
                fq_mul(t3, denoms[di++], lam);
                Fq x3, y3;
                fq_sqr(lam, x3);
                fq_sub(x3, b.x, x3);
                fq_sub(x3, b.x, x3);
                fq_sub(b.x, x3, t);
                fq_mul(lam, t, y3);
                fq_sub(y3, b.y, y3);
                b.x = x3;
                b.y = y3;
                break;
            }
        }
    }
}

int pick_window_ba(size_t n) {
    // cost ~ (255/c) * (n*6 + 2^c*2*16) field muls; sweep small c
    double best = 1e30;
    int bestc = 4;
    for (int c = 3; c <= 13; ++c) {
        double w = (255.0 + c - 1) / c;
        double cost = w * (n * 6.0 + (double)(1 << c) * 2.0 * 16.0);
        if (cost < best) { best = cost; bestc = c; }
    }
    return bestc;
}

void msm_batch_affine(const G1 *jac_pts, const uint8_t *scalars, size_t n,
                      G1 &out) {
    // normalise inputs to affine once
    std::vector<G1> norm(jac_pts, jac_pts + n);
    batch_normalize(norm.data(), n);
    std::vector<AffPt> pts(n);
    for (size_t i = 0; i < n; ++i) {
        pts[i].inf = g1_is_inf(norm[i]);
        pts[i].x = norm[i].x;
        pts[i].y = norm[i].y;
    }

    int c = pick_window_ba(n);
    int windows = (255 + c - 1) / c;
    size_t nb = ((size_t)1 << c) - 1;  // buckets 1..2^c-1, slot b-1

    std::vector<AffPt> buckets(windows * nb);
    for (auto &b : buckets) b.inf = true;

    // occupancy lists: for every (window,bucket) the point indices
    std::vector<std::vector<int64_t>> occ(windows * nb);
    for (size_t i = 0; i < n; ++i) {
        const uint8_t *s = scalars + 32 * i;
        for (int w = 0; w < windows; ++w) {
            unsigned digit = extract_digit(s, w * c, c);
            if (digit) occ[(size_t)w * nb + digit - 1].push_back((int64_t)i);
        }
    }
    size_t max_occ = 0;
    for (auto &v : occ) max_occ = v.size() > max_occ ? v.size() : max_occ;

    std::vector<int64_t> slots, pis;
    std::vector<Fq> denoms;
    std::vector<int> kinds;
    for (size_t t = 0; t < max_occ; ++t) {
        slots.clear();
        pis.clear();
        for (size_t sb = 0; sb < occ.size(); ++sb) {
            if (occ[sb].size() > t) {
                slots.push_back((int64_t)sb);
                pis.push_back(occ[sb][t]);
            }
        }
        affine_add_pass(buckets.data(), slots.data(), pts.data(), pis.data(),
                        slots.size(), denoms, kinds);
    }

    // combine: per window running/weighted sums (jacobian), then the ladder
    g1_set_inf(out);
    G1 t;
    for (int w = windows - 1; w >= 0; --w) {
        for (int k = 0; k < c; ++k) g1_double(out, out);
        G1 running, wsum;
        g1_set_inf(running);
        g1_set_inf(wsum);
        // find highest occupied bucket to shorten the chain
        size_t hi = 0;
        for (size_t b = nb; b-- > 0;) {
            if (!buckets[(size_t)w * nb + b].inf) { hi = b + 1; break; }
        }
        for (size_t b = hi; b-- > 0;) {
            const AffPt &bk = buckets[(size_t)w * nb + b];
            if (!bk.inf) {
                G1 q;
                q.x = bk.x;
                q.y = bk.y;
                std::memcpy(q.z.l, ONE_MONT, 48);
                g1_add(running, q, t);
                running = t;
            }
            g1_add(wsum, running, t);
            wsum = t;
        }
        g1_add(out, wsum, t);
        out = t;
    }
}

}  // namespace

extern "C" {

void cp_msm_ba(const uint8_t *points, const uint8_t *scalars, uint64_t n,
               uint8_t *out) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, pts[i]);
    G1 r;
    msm_batch_affine(pts.data(), scalars, n, r);
    store_g1(r, out);
}

}  // extern "C"

// ---- Fr (scalar field) Montgomery arithmetic: 4x64 CIOS ----
// The batch-verification replay burns most of its time in python bigint
// mulmods over Fr (IPA verification-scalar chains, power vectors); these
// kernels run whole chains natively on 32-byte LE canonical boundaries.

namespace {

struct Fr4 {
    u64 l[4];
};

inline void fr4_mont_mul(const Fr4 &a, const Fr4 &b, Fr4 &r) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 c = 0;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 cur =
                (unsigned __int128)a.l[j] * b.l[i] + t[j] + (u64)c;
            t[j] = (u64)cur;
            c = cur >> 64;
        }
        unsigned __int128 cur = (unsigned __int128)t[4] + (u64)c;
        t[4] = (u64)cur;
        t[5] = (u64)(cur >> 64);
        u64 m = t[0] * FR_INV64;
        c = ((unsigned __int128)m * R_ORDER[0] + t[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            cur = (unsigned __int128)m * R_ORDER[j] + t[j] + (u64)c;
            t[j - 1] = (u64)cur;
            c = cur >> 64;
        }
        cur = (unsigned __int128)t[4] + (u64)c;
        t[3] = (u64)cur;
        t[4] = t[5] + (u64)(cur >> 64);
        t[5] = 0;
    }
    bool ge = t[4] != 0;
    if (!ge) {
        ge = true;
        for (int j = 3; j >= 0; --j) {
            if (t[j] != R_ORDER[j]) {
                ge = t[j] > R_ORDER[j];
                break;
            }
        }
    }
    if (ge) {
        unsigned __int128 borrow = 0;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 cur = (unsigned __int128)t[j] - R_ORDER[j]
                                    - (u64)borrow;
            r.l[j] = (u64)cur;
            borrow = (cur >> 64) ? 1 : 0;
        }
    } else {
        for (int j = 0; j < 4; ++j) r.l[j] = t[j];
    }
}

inline void fr4_load(const uint8_t *in, Fr4 &out) {  // canonical LE -> mont
    std::memcpy(out.l, in, 32);
    Fr4 r2;
    std::memcpy(r2.l, FR_R2, 32);
    Fr4 t;
    fr4_mont_mul(out, r2, t);
    out = t;
}

inline void fr4_store(const Fr4 &in, uint8_t *out, bool negate) {
    Fr4 one = {{1, 0, 0, 0}};  // mont_mul by plain 1 == from_mont
    Fr4 v;
    fr4_mont_mul(in, one, v);
    bool zero = (v.l[0] | v.l[1] | v.l[2] | v.l[3]) == 0;
    if (negate && !zero) {
        unsigned __int128 borrow = 0;
        Fr4 n;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 cur = (unsigned __int128)R_ORDER[j] - v.l[j]
                                    - (u64)borrow;
            n.l[j] = (u64)cur;
            borrow = (cur >> 64) ? 1 : 0;
        }
        v = n;
    }
    std::memcpy(out, v.l, 32);
}

}  // namespace

extern "C" {

// Verification-scalar products (util.py semantics): out[i] =
// cmul * prod_{j: bit (logn-1-j) of i set} ch[j]  [* mulvec[i]]  [negated].
// One Montgomery mul per entry via s_i = s_{i & (i-1)} * ch[logn-1-ctz(i)].
// All byte vectors are 32-byte LE canonical Fr.
void cp_fr_vsp(const uint8_t *ch, uint64_t logn, uint64_t n,
               const uint8_t *cmul, const uint8_t *mulvec, int32_t neg,
               uint8_t *out) {
    Fr4 c[32];
    for (uint64_t i = 0; i < logn && i < 32; ++i) fr4_load(ch + 32 * i, c[i]);
    std::vector<Fr4> s(n);
    if (cmul) {
        fr4_load(cmul, s[0]);
    } else {
        std::memcpy(s[0].l, FR_ONE_MONT, 32);
    }
    for (uint64_t i = 1; i < n; ++i) {
        int b = __builtin_ctzll(i);
        fr4_mont_mul(s[i & (i - 1)], c[logn - 1 - b], s[i]);
    }
    for (uint64_t i = 0; i < n; ++i) {
        Fr4 v = s[i];
        if (mulvec) {
            Fr4 m;
            fr4_load(mulvec + 32 * i, m);
            Fr4 t;
            fr4_mont_mul(v, m, t);
            v = t;
        }
        fr4_store(v, out + 32 * i, neg != 0);
    }
}

// out[i] = rf * xs[i] mod r — canonical LE in and out.  One Montgomery mul
// per element: mont_mul(x_plain, to_mont(rf)) = x*rf*R*R^-1 = x*rf.
void cp_fr_scale_vec(const uint8_t *rf, const uint8_t *xs, uint64_t n,
                     uint8_t *out) {
    Fr4 f;
    fr4_load(rf, f);  // f * R
    for (uint64_t i = 0; i < n; ++i) {
        Fr4 x, t;
        std::memcpy(x.l, xs + 32 * i, 32);  // plain
        fr4_mont_mul(x, f, t);              // = x * rf, already canonical
        std::memcpy(out + 32 * i, t.l, 32);
    }
}

// acc[keys[i]] += rf * xs[i] mod r for i in [0, n) — the scale+merge half
// of the verifier's batched-MSM dedup (msm_accumulator.rs:37-52 semantics,
// but deferred to one fused native sweep). xs and acc are canonical LE
// 32-byte scalars; keys index 32-byte slots of acc (caller zeroes acc).
void cp_fr_scale_accum(const uint8_t *rf, const uint8_t *xs,
                       const uint8_t *keys_le32, uint64_t n, uint8_t *acc) {
    Fr4 f;
    fr4_load(rf, f);  // -> mont, so mont_mul(x_plain, f) = x * rf plain
    for (uint64_t i = 0; i < n; ++i) {
        Fr4 x, t, a;
        std::memcpy(x.l, xs + 32 * i, 32);
        fr4_mont_mul(x, f, t);
        uint32_t key;
        std::memcpy(&key, keys_le32 + 4 * i, 4);
        uint8_t *dst = acc + 32 * (uint64_t)key;
        std::memcpy(a.l, dst, 32);
        unsigned __int128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 cur =
                (unsigned __int128)a.l[j] + t.l[j] + (u64)carry;
            a.l[j] = (u64)cur;
            carry = cur >> 64;
        }
        bool ge = carry != 0;
        if (!ge) {
            ge = true;
            for (int j = 3; j >= 0; --j) {
                if (a.l[j] != R_ORDER[j]) {
                    ge = a.l[j] > R_ORDER[j];
                    break;
                }
            }
        }
        if (ge) {
            unsigned __int128 borrow = 0;
            for (int j = 0; j < 4; ++j) {
                unsigned __int128 cur =
                    (unsigned __int128)a.l[j] - R_ORDER[j] - (u64)borrow;
                a.l[j] = (u64)cur;
                borrow = (cur >> 64) ? 1 : 0;
            }
        }
        std::memcpy(dst, a.l, 32);
    }
}

// out[i] = base^(i+1) for i in [0, n) — canonical LE in and out.
void cp_fr_powers(const uint8_t *base, uint64_t n, uint8_t *out) {
    Fr4 b;
    fr4_load(base, b);
    Fr4 acc = b;
    for (uint64_t i = 0; i < n; ++i) {
        fr4_store(acc, out + 32 * i, false);
        Fr4 t;
        fr4_mont_mul(acc, b, t);
        acc = t;
    }
}

}  // extern "C"

// ---- Fr bulk chains for the batched lockstep prover ----
// The batched prover (parallel/batch_prove.py) re-expresses every folding-
// round MSM over the ORIGINAL resident bases with composite scalars
// (witness x gamma-weight outer products), so its per-round host work is
// these bulk canonical-LE chains instead of python bigint loops.

namespace {

inline void fr4_add_mod(Fr4 &a, const Fr4 &t) {
    unsigned __int128 carry = 0;
    for (int j = 0; j < 4; ++j) {
        unsigned __int128 cur = (unsigned __int128)a.l[j] + t.l[j]
                                + (u64)carry;
        a.l[j] = (u64)cur;
        carry = cur >> 64;
    }
    bool ge = carry != 0;
    if (!ge) {
        ge = true;
        for (int j = 3; j >= 0; --j) {
            if (a.l[j] != R_ORDER[j]) {
                ge = a.l[j] > R_ORDER[j];
                break;
            }
        }
    }
    if (ge) {
        unsigned __int128 borrow = 0;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 cur = (unsigned __int128)a.l[j] - R_ORDER[j]
                                    - (u64)borrow;
            a.l[j] = (u64)cur;
            borrow = (cur >> 64) ? 1 : 0;
        }
    }
}

}  // namespace

extern "C" {

// out[i*nb + j] = a[i] * b[j] mod r — the composite-scalar outer product of
// one folding-round relation (witness half x gamma-weight vector).
// mont_mul(a_plain, b_mont) = a*b canonical: one mul per output entry.
void cp_fr_outer(const uint8_t *a, uint64_t na, const uint8_t *b,
                 uint64_t nb, uint8_t *out) {
    std::vector<Fr4> bm(nb);
    for (uint64_t j = 0; j < nb; ++j) fr4_load(b + 32 * j, bm[j]);
    for (uint64_t i = 0; i < na; ++i) {
        Fr4 x;
        std::memcpy(x.l, a + 32 * i, 32);
        uint8_t *row = out + 32 * i * nb;
        for (uint64_t j = 0; j < nb; ++j) {
            Fr4 t;
            fr4_mont_mul(x, bm[j], t);
            std::memcpy(row + 32 * j, t.l, 32);
        }
    }
}

// out[i] = x[i] + g * y[i] mod r — the witness fold of one round
// (c = c_L + gamma_inv * c_R and friends).
void cp_fr_axpy(const uint8_t *g, const uint8_t *x, const uint8_t *y,
                uint64_t n, uint8_t *out) {
    Fr4 gm;
    fr4_load(g, gm);
    for (uint64_t i = 0; i < n; ++i) {
        Fr4 xv, yv, t;
        std::memcpy(xv.l, x + 32 * i, 32);
        std::memcpy(yv.l, y + 32 * i, 32);
        fr4_mont_mul(yv, gm, t);  // g * y, canonical
        fr4_add_mod(t, xv);
        std::memcpy(out + 32 * i, t.l, 32);
    }
}

// out[i] = a[i] * b[i] mod r elementwise (e.g. composite scalars x the
// gathered beta-inverse rescaling of the grand-product G' bases).
void cp_fr_mul_vec(const uint8_t *a, const uint8_t *b, uint64_t n,
                   uint8_t *out) {
    Fr4 r2;
    std::memcpy(r2.l, FR_R2, 32);
    for (uint64_t i = 0; i < n; ++i) {
        Fr4 x, y, t, v;
        std::memcpy(x.l, a + 32 * i, 32);
        std::memcpy(y.l, b + 32 * i, 32);
        fr4_mont_mul(x, y, t);   // a*b/R
        fr4_mont_mul(t, r2, v);  // a*b
        std::memcpy(out + 32 * i, v.l, 32);
    }
}

// Exclusive prefix products: out[0] = 1, out[i] = x[0]*...*x[i-1] mod r —
// the grand-product witness vector (grand_product_argument.rs:69-73).
void cp_fr_prefix_prod(const uint8_t *xs, uint64_t n, uint8_t *out) {
    Fr4 acc;
    std::memcpy(acc.l, FR_ONE_MONT, 32);  // 1 in mont
    Fr4 one = {{1, 0, 0, 0}};
    for (uint64_t i = 0; i < n; ++i) {
        Fr4 v;
        fr4_mont_mul(acc, one, v);  // -> canonical
        std::memcpy(out + 32 * i, v.l, 32);
        Fr4 x, t;
        fr4_load(xs + 32 * i, x);
        fr4_mont_mul(acc, x, t);
        acc = t;
    }
}

// m independent inner products over contiguous [m, n] operand blocks:
// out[k] = sum_i a[k*n + i] * b[k*n + i] mod r (the L_C/R_C z-terms of a
// whole proof batch in one sweep).
void cp_fr_inner_many(const uint8_t *a, const uint8_t *b, uint64_t n,
                      uint64_t m, uint8_t *out) {
    Fr4 r2;
    std::memcpy(r2.l, FR_R2, 32);
    for (uint64_t k = 0; k < m; ++k) {
        Fr4 acc = {{0, 0, 0, 0}};
        const uint8_t *ak = a + 32 * k * n;
        const uint8_t *bk = b + 32 * k * n;
        for (uint64_t i = 0; i < n; ++i) {
            Fr4 x, y, t;
            std::memcpy(x.l, ak + 32 * i, 32);
            std::memcpy(y.l, bk + 32 * i, 32);
            fr4_mont_mul(x, y, t);  // a*b/R
            fr4_add_mod(acc, t);
        }
        Fr4 v;
        fr4_mont_mul(acc, r2, v);  // undo the /R
        std::memcpy(out + 32 * k, v.l, 32);
    }
}

}  // extern "C"

// ---- IFMA batch domain conversion + self-test ----

#if CP_HAVE_IFMA

namespace {

// mont64 Fq (a*2^384, 6x64 limbs) -> packed mont52 (a*2^416, 8x52 limbs)
void convert_to52_batch(const Fq *in, size_t n, u64 *out) {
    ifma::Fq8 conv;
    ifma::broadcast8(CONV_IN52, conv);
    u64 buf[8][8];
    for (size_t base = 0; base < n; base += 8) {
        size_t m = n - base < 8 ? n - base : 8;
        for (size_t k = 0; k < m; ++k) ifma::repack_6to8(in[base + k].l, buf[k]);
        for (size_t k = m; k < 8; ++k) std::memset(buf[k], 0, 64);
        const u64 *srcs[8];
        u64 *dsts[8];
        for (int k = 0; k < 8; ++k) { srcs[k] = buf[k]; dsts[k] = buf[k]; }
        ifma::Fq8 v;
        ifma::load8(srcs, v);
        ifma::montmul8(v, conv, v);
        ifma::store8(v, dsts);
        std::memcpy(out + base * 8, buf, m * 64);
    }
}

// packed mont52 -> mont64 Fq
void convert_from52_batch(const u64 *in, size_t n, Fq *out) {
    ifma::Fq8 conv;
    ifma::broadcast8(CONV_OUT52, conv);
    u64 buf[8][8];
    for (size_t base = 0; base < n; base += 8) {
        size_t m = n - base < 8 ? n - base : 8;
        std::memcpy(buf, in + base * 8, m * 64);
        for (size_t k = m; k < 8; ++k) std::memset(buf[k], 0, 64);
        const u64 *srcs[8];
        u64 *dsts[8];
        for (int k = 0; k < 8; ++k) { srcs[k] = buf[k]; dsts[k] = buf[k]; }
        ifma::Fq8 v;
        ifma::load8(srcs, v);
        ifma::montmul8(v, conv, v);
        ifma::store8(v, dsts);
        for (size_t k = 0; k < m; ++k) ifma::repack_8to6(buf[k], out[base + k].l);
    }
}

}  // namespace

#endif  // CP_HAVE_IFMA

extern "C" {

int cp_ifma_available(void) { return CP_HAVE_IFMA; }

// round-trips 8*reps pseudorandom field elements through the IFMA domain and
// cross-checks montmul8/add8/sub8/neg8 against the scalar ADX/CIOS path.
// Returns 0 on success, a nonzero failure code otherwise.
int cp_ifma_selftest(void) {
#if CP_HAVE_IFMA
    u64 seed = 0x243f6a8885a308d3ULL;
    auto next = [&seed]() {
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        return seed;
    };
    for (int rep = 0; rep < 64; ++rep) {
        Fq a[8], b[8], want_mul[8], want_add[8], want_sub[8], want_neg[8];
        for (int k = 0; k < 8; ++k) {
            for (int j = 0; j < 6; ++j) { a[k].l[j] = next(); b[k].l[j] = next(); }
            a[k].l[5] &= (1ULL << 61) - 1;  // < 2^381-ish, then reduce
            b[k].l[5] &= (1ULL << 61) - 1;
            while (fq_geq_p(a[k])) fq_sub_p(a[k]);
            while (fq_geq_p(b[k])) fq_sub_p(b[k]);
            if (rep == 0 && k == 0) std::memset(a[k].l, 0, 48);  // zero lane
            fq_mul(a[k], b[k], want_mul[k]);
            fq_add(a[k], b[k], want_add[k]);
            fq_sub(a[k], b[k], want_sub[k]);
            fq_neg(a[k], want_neg[k]);
        }
        u64 pa[8 * 8], pb[8 * 8], pr[8 * 8];
        convert_to52_batch(a, 8, pa);
        convert_to52_batch(b, 8, pb);
        const u64 *sa[8], *sb[8];
        u64 *dr[8];
        for (int k = 0; k < 8; ++k) {
            sa[k] = pa + 8 * k; sb[k] = pb + 8 * k; dr[k] = pr + 8 * k;
        }
        ifma::Fq8 va, vb, vr;
        ifma::load8(sa, va);
        ifma::load8(sb, vb);
        Fq got[8];
        ifma::montmul8(va, vb, vr);
        ifma::store8(vr, dr);
        convert_from52_batch(pr, 8, got);
        for (int k = 0; k < 8; ++k)
            if (std::memcmp(got[k].l, want_mul[k].l, 48)) return 1;
        ifma::add8(va, vb, vr);
        ifma::store8(vr, dr);
        convert_from52_batch(pr, 8, got);
        for (int k = 0; k < 8; ++k)
            if (std::memcmp(got[k].l, want_add[k].l, 48)) return 2;
        ifma::sub8(va, vb, vr);
        ifma::store8(vr, dr);
        convert_from52_batch(pr, 8, got);
        for (int k = 0; k < 8; ++k)
            if (std::memcmp(got[k].l, want_sub[k].l, 48)) return 3;
        ifma::neg8(va, vr);
        ifma::store8(vr, dr);
        convert_from52_batch(pr, 8, got);
        for (int k = 0; k < 8; ++k)
            if (std::memcmp(got[k].l, want_neg[k].l, 48)) return 4;
        Fq want_sqr[8];
        for (int k = 0; k < 8; ++k) fq_mul(a[k], a[k], want_sqr[k]);
        ifma::sqr8(va, vr);
        ifma::store8(vr, dr);
        convert_from52_batch(pr, 8, got);
        for (int k = 0; k < 8; ++k)
            if (std::memcmp(got[k].l, want_sqr[k].l, 48)) return 5;
    }
    return 0;
#else
    return -1;
#endif
}

}  // extern "C"

// ---- IFMA 8-wide Jacobian group law + shared-scalar GLV ladder ----
// Vectorizes the fold / batch-scalar-mul hot loops (inner_product_argument.rs
// :170-179 point folds, grand_product_argument.rs:90-102 basis rescaling):
// eight points advance through the same double-and-add schedule in lockstep,
// one field op per limb-vector instruction.

#if CP_HAVE_IFMA

namespace {

struct Jac8 {
    ifma::Fq8 X, Y, Z;  // Z == 0 lane => infinity
};

inline void set_inf_jac8(Jac8 &p) {
    ifma::set_zero8(p.X);
    ifma::set_zero8(p.Y);
    ifma::set_zero8(p.Z);
}

// P[k] = 2 P[k] for K independent lane-groups; each field-op step runs the K
// instances back-to-back so the montmul8 pipeline stays full (a single group
// is latency-bound: the group law is one long dependency chain).
// Handles infinity lanes implicitly: Z3 = 2YZ = 0.
template <int K>
void dbl_jacK(Jac8 *p) {
    using namespace ifma;
    Fq8 A[K], B[K], C[K], D[K], E[K], F[K], t[K], x3[K], y3[K], z3[K], c8[K];
#define FORK for (int k = 0; k < K; ++k)
    FORK sqr8(p[k].X, A[k]);
    FORK sqr8(p[k].Y, B[k]);
    FORK sqr8(B[k], C[k]);
    FORK add8(p[k].X, B[k], t[k]);
    FORK sqr8(t[k], t[k]);
    FORK sub8(t[k], A[k], t[k]);
    FORK sub8(t[k], C[k], t[k]);
    FORK dbl8(t[k], D[k]);
    FORK dbl8(A[k], E[k]);
    FORK add8(E[k], A[k], E[k]);          // E = 3A
    FORK sqr8(E[k], F[k]);
    FORK sub8(F[k], D[k], x3[k]);
    FORK sub8(x3[k], D[k], x3[k]);        // X3 = F - 2D
    FORK montmul8(p[k].Y, p[k].Z, z3[k]);
    FORK dbl8(z3[k], p[k].Z);             // Z3 = 2YZ
    FORK sub8(D[k], x3[k], t[k]);
    FORK montmul8(E[k], t[k], y3[k]);
    FORK dbl8(C[k], c8[k]);
    FORK dbl8(c8[k], c8[k]);
    FORK dbl8(c8[k], c8[k]);              // 8C
    FORK sub8(y3[k], c8[k], p[k].Y);
    FORK p[k].X = x3[k];
#undef FORK
}

inline void dbl_jac8(Jac8 &p) { dbl_jacK<1>(&p); }

// P[k] = P[k] + Q[k] (general Jacobian add, a = 0) for K independent groups.
// Degenerate lanes resolved with masks: P inf -> Q, Q inf -> P,
// H == 0 && r == 0 -> double, H == 0 && r != 0 -> infinity.
template <int K>
void add_jacK(Jac8 *p, const Jac8 *q) {
    using namespace ifma;
    __mmask8 pinf[K], qinf[K], hz, dblm[K], cancel[K];
    Fq8 z1z1[K], z2z2[K], u1[K], u2[K], s1[K], s2[K], h[K], r[K];
    Fq8 i[K], j[K], v[K], x3[K], y3[K], z3[K], t[K];
    Jac8 saved[K];
#define FORK for (int k = 0; k < K; ++k)
    FORK saved[k] = p[k];
    FORK pinf[k] = is_zero8(p[k].Z);
    FORK qinf[k] = is_zero8(q[k].Z);
    FORK sqr8(p[k].Z, z1z1[k]);
    FORK sqr8(q[k].Z, z2z2[k]);
    FORK montmul8(p[k].X, z2z2[k], u1[k]);
    FORK montmul8(q[k].X, z1z1[k], u2[k]);
    FORK montmul8(p[k].Y, q[k].Z, s1[k]);
    FORK montmul8(s1[k], z2z2[k], s1[k]);
    FORK montmul8(q[k].Y, p[k].Z, s2[k]);
    FORK montmul8(s2[k], z1z1[k], s2[k]);
    FORK sub8(u2[k], u1[k], h[k]);
    FORK sub8(s2[k], s1[k], r[k]);
    FORK dbl8(r[k], r[k]);
    bool any_dbl = false;
    FORK {
        hz = (__mmask8)(is_zero8(h[k]) & ~pinf[k] & ~qinf[k]);
        dblm[k] = (__mmask8)(hz & is_zero8(r[k]));
        cancel[k] = (__mmask8)(hz & ~dblm[k]);
        if (dblm[k]) any_dbl = true;
    }
    FORK dbl8(h[k], i[k]);
    FORK sqr8(i[k], i[k]);              // I = (2H)^2
    FORK montmul8(h[k], i[k], j[k]);    // J = H*I
    FORK montmul8(u1[k], i[k], v[k]);   // V = U1*I
    FORK sqr8(r[k], x3[k]);
    FORK sub8(x3[k], j[k], x3[k]);
    FORK sub8(x3[k], v[k], x3[k]);
    FORK sub8(x3[k], v[k], x3[k]);      // X3 = r^2 - J - 2V
    FORK sub8(v[k], x3[k], t[k]);
    FORK montmul8(r[k], t[k], y3[k]);
    FORK montmul8(s1[k], j[k], t[k]);
    FORK dbl8(t[k], t[k]);
    FORK sub8(y3[k], t[k], y3[k]);      // Y3 = r(V-X3) - 2 S1 J
    FORK add8(p[k].Z, q[k].Z, z3[k]);
    FORK sqr8(z3[k], z3[k]);
    FORK sub8(z3[k], z1z1[k], z3[k]);
    FORK sub8(z3[k], z2z2[k], z3[k]);
    FORK montmul8(z3[k], h[k], z3[k]);  // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
    Jac8 dbl_res[K];
    if (any_dbl) {
        FORK { dbl_res[k] = p[k]; }
        dbl_jacK<K>(dbl_res);
    }
    FORK {
        select8(pinf[k], q[k].X, x3[k], p[k].X);
        select8(pinf[k], q[k].Y, y3[k], p[k].Y);
        select8(pinf[k], q[k].Z, z3[k], p[k].Z);
        if (qinf[k]) {
            select8(qinf[k], saved[k].X, p[k].X, p[k].X);
            select8(qinf[k], saved[k].Y, p[k].Y, p[k].Y);
            select8(qinf[k], saved[k].Z, p[k].Z, p[k].Z);
        }
        if (dblm[k]) {
            select8(dblm[k], dbl_res[k].X, p[k].X, p[k].X);
            select8(dblm[k], dbl_res[k].Y, p[k].Y, p[k].Y);
            select8(dblm[k], dbl_res[k].Z, p[k].Z, p[k].Z);
        }
        if (cancel[k]) {
            Fq8 zero;
            set_zero8(zero);
            select8(cancel[k], zero, p[k].Z, p[k].Z);
        }
    }
#undef FORK
}

inline void add_jac8(Jac8 &p, const Jac8 &q) { add_jacK<1>(&p, &q); }

// signed base-16 digit recode of a <=128-bit little-endian value;
// out[nwin] digits in [-8, 8]
int recode16(const uint8_t k[16], int digits[34]) {
    int nwin = 33;  // ceil(129/4)
    unsigned carry = 0;
    for (int w = 0; w < nwin; ++w) {
        int bit_lo = w * 4;
        unsigned v = carry;
        if (bit_lo < 128) {
            unsigned byte = (unsigned)k[bit_lo >> 3];
            v += (bit_lo & 4) ? (byte >> 4) : (byte & 0xf);
        }
        if (v > 8) { digits[w] = (int)v - 16; carry = 1; }
        else { digits[w] = (int)v; carry = 0; }
    }
    while (nwin > 1 && digits[nwin - 1] == 0) --nwin;
    return nwin;
}

// Shared-scalar GLV ladder over K interleaved groups of 8 points each
// (the interleave hides montmul8 latency; K = 2 is the sweet spot on the
// target Xeon). b1/b2: the two effective bases (sign of the GLV halves
// already applied), affine mont52 vertical. Tables hold 1..8 multiples in
// Jacobian form; digits are SHARED across all points (same scalar).
template <int K>
void ladder_groupK(const ifma::Fq8 *b1x, const ifma::Fq8 *b1y,
                   const __mmask8 *b1inf, const ifma::Fq8 *b2x,
                   const ifma::Fq8 *b2y, const __mmask8 *b2inf,
                   const int *d1, const int *d2, int nwin, Jac8 *acc) {
    using namespace ifma;
    Fq8 one, zero;
    broadcast8(ONE_MONT52, one);
    set_zero8(zero);
    Jac8 tab[2][8][K];  // [base][entry][instance]
    for (int bsel = 0; bsel < 2; ++bsel) {
        Jac8(*t)[K] = tab[bsel];
        for (int k = 0; k < K; ++k) {
            t[0][k].X = bsel ? b2x[k] : b1x[k];
            t[0][k].Y = bsel ? b2y[k] : b1y[k];
            __mmask8 inf = bsel ? b2inf[k] : b1inf[k];
            select8(inf, zero, one, t[0][k].Z);  // infinity lanes: Z = 0
        }
#define CPY(d, s) for (int k = 0; k < K; ++k) t[d][k] = t[s][k]
        CPY(1, 0); dbl_jacK<K>(t[1]);                      // 2P
        CPY(2, 1); add_jacK<K>(t[2], t[0]);                // 3P
        CPY(3, 1); dbl_jacK<K>(t[3]);                      // 4P
        CPY(4, 3); add_jacK<K>(t[4], t[0]);                // 5P
        CPY(5, 2); dbl_jacK<K>(t[5]);                      // 6P
        CPY(6, 5); add_jacK<K>(t[6], t[0]);                // 7P
        CPY(7, 3); dbl_jacK<K>(t[7]);                      // 8P
#undef CPY
    }
    for (int k = 0; k < K; ++k) set_inf_jac8(acc[k]);
    bool started = false;
    for (int w = nwin - 1; w >= 0; --w) {
        if (started)
            for (int s = 0; s < 4; ++s) dbl_jacK<K>(acc);
        for (int bsel = 0; bsel < 2; ++bsel) {
            int d = bsel ? d2[w] : d1[w];
            if (!d) continue;
            started = true;
            Jac8(*t)[K] = tab[bsel];
            const Jac8 *e = t[(d < 0 ? -d : d) - 1];
            if (d > 0) {
                add_jacK<K>(acc, e);
            } else {
                Jac8 en[K];
                for (int k = 0; k < K; ++k) {
                    en[k] = e[k];
                    neg8(e[k].Y, en[k].Y);
                }
                add_jacK<K>(acc, en);
            }
        }
    }
}

// the ladder pass of fold_ifma over all lane groups, K instances in flight
// (K picked at runtime via CP_FOLD_K; deeper interleave hides more montmul
// latency at the cost of table cache footprint — ~25 KB per instance)
template <int K>
void fold_ladder_pass(uint64_t n, const u64 *p1x, const u64 *p1y,
                      const u64 *p2x, const u64 *p2y, const uint8_t *inf,
                      const u64 *lx, const u64 *ly, const u64 *lz,
                      const int *d1, const int *d2, int nwin,
                      u64 *ox, u64 *oy, u64 *oz) {
    using namespace ifma;
    for (size_t base = 0; base < n; base += 8 * K) {
        Fq8 B1X[K], B1Y[K], B2X[K], B2Y[K];
        __mmask8 infm[K];
        unsigned lanes[K];
        for (int g = 0; g < K; ++g) {
            size_t gb = base + 8 * (size_t)g;
            size_t m = gb >= n ? 0 : (n - gb < 8 ? n - gb : 8);
            lanes[g] = m == 8 ? 0xffu : ((1u << m) - 1u);
            const u64 *s1x[8], *s1y[8], *s2x[8], *s2y[8];
            infm[g] = 0;
            for (int kk = 0; kk < 8; ++kk) {
                size_t e = (size_t)kk < m ? gb + kk : base;
                s1x[kk] = p1x + e * 8;
                s1y[kk] = p1y + e * 8;
                s2x[kk] = p2x + e * 8;
                s2y[kk] = p2y + e * 8;
                if ((size_t)kk >= m || inf[e])
                    infm[g] = (__mmask8)(infm[g] | (1u << kk));
            }
            load8(s1x, B1X[g]); load8(s1y, B1Y[g]);
            load8(s2x, B2X[g]); load8(s2y, B2Y[g]);
        }
        Jac8 acc[K];
        ladder_groupK<K>(B1X, B1Y, infm, B2X, B2Y, infm, d1, d2, nwin, acc);
        if (lx) {
            Jac8 L[K];
            for (int g = 0; g < K; ++g) {
                size_t gb = base + 8 * (size_t)g;
                size_t m = gb >= n ? 0 : (n - gb < 8 ? n - gb : 8);
                const u64 *slx[8], *sly[8], *slz[8];
                for (int kk = 0; kk < 8; ++kk) {
                    size_t e = (size_t)kk < m ? gb + kk : base;
                    slx[kk] = lx + e * 8;
                    sly[kk] = ly + e * 8;
                    slz[kk] = lz + e * 8;
                }
                load8(slx, L[g].X); load8(sly, L[g].Y); load8(slz, L[g].Z);
            }
            add_jacK<K>(acc, L);
        }
        for (int g = 0; g < K; ++g) {
            if (!lanes[g]) continue;
            size_t gb = base + 8 * (size_t)g;
            u64 *dx[8], *dy[8], *dz[8];
            for (int kk = 0; kk < 8; ++kk) {
                size_t e = gb + (size_t)kk;
                size_t safe = e < n ? e : gb;
                dx[kk] = ox + safe * 8;
                dy[kk] = oy + safe * 8;
                dz[kk] = oz + safe * 8;
            }
            store8(acc[g].X, dx, lanes[g]);
            store8(acc[g].Y, dy, lanes[g]);
            store8(acc[g].Z, dz, lanes[g]);
        }
    }
}

inline int fold_interleave_depth() {
    const char *e = std::getenv("CP_FOLD_K");
    int v = e ? std::atoi(e) : 2;
    return (v >= 1 && v <= 4) ? v : 2;
}

// out[i] = (left ? left[i] : 0) + k*right[i] for the SHARED GLV-split scalar
// (k1, k2 16-byte magnitudes; signs neg1/neg2). Outputs batch-normalized
// (z = 1). Eight points per lane-group, whole ladder per group so the
// per-group tables stay cache-resident.
void fold_ifma(const uint8_t *left_bytes, const uint8_t *points, uint64_t n,
               const uint8_t *beta48, const uint8_t *k1, int neg1,
               const uint8_t *k2, int neg2, uint8_t *out) {
    using namespace ifma;
    if (!n) return;
    std::vector<G1> right(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, right[i]);
    batch_normalize(right.data(), n);
    Fq beta;
    load_fq(beta48, beta);
    std::vector<Fq> b1x(n), b1y(n), b2x(n), b2y(n);
    std::vector<uint8_t> inf(n);
    for (uint64_t i = 0; i < n; ++i) {
        inf[i] = g1_is_inf(right[i]);
        if (inf[i]) {
            std::memset(b1x[i].l, 0, 48); std::memset(b1y[i].l, 0, 48);
            b2x[i] = b1x[i]; b2y[i] = b1y[i];
            continue;
        }
        b1x[i] = right[i].x;
        fq_mul(right[i].x, beta, b2x[i]);
        if (neg1) fq_neg(right[i].y, b1y[i]); else b1y[i] = right[i].y;
        if (neg2) fq_neg(right[i].y, b2y[i]); else b2y[i] = right[i].y;
    }
    size_t ng = ((size_t)n + 7) / 8;
    std::vector<u64> p1x(ng * 64), p1y(ng * 64), p2x(ng * 64), p2y(ng * 64);
    convert_to52_batch(b1x.data(), n, p1x.data());
    convert_to52_batch(b1y.data(), n, p1y.data());
    convert_to52_batch(b2x.data(), n, p2x.data());
    convert_to52_batch(b2y.data(), n, p2y.data());
    std::vector<u64> lx, ly, lz;
    if (left_bytes) {
        std::vector<Fq> t(n);
        lx.resize(ng * 64); ly.resize(ng * 64); lz.resize(ng * 64);
        for (uint64_t i = 0; i < n; ++i) load_fq(left_bytes + 144 * i, t[i]);
        convert_to52_batch(t.data(), n, lx.data());
        for (uint64_t i = 0; i < n; ++i) load_fq(left_bytes + 144 * i + 48, t[i]);
        convert_to52_batch(t.data(), n, ly.data());
        for (uint64_t i = 0; i < n; ++i) load_fq(left_bytes + 144 * i + 96, t[i]);
        convert_to52_batch(t.data(), n, lz.data());
    }
    int d1[34], d2[34];
    int w1 = recode16(k1, d1), w2 = recode16(k2, d2);
    int nwin = w1 > w2 ? w1 : w2;
    for (int w = w1; w < nwin; ++w) d1[w] = 0;
    for (int w = w2; w < nwin; ++w) d2[w] = 0;

    std::vector<u64> ox(ng * 64), oy(ng * 64), oz(ng * 64);
    const u64 *lpx = left_bytes ? lx.data() : nullptr;
    const u64 *lpy = left_bytes ? ly.data() : nullptr;
    const u64 *lpz = left_bytes ? lz.data() : nullptr;
    switch (fold_interleave_depth()) {
        case 1:
            fold_ladder_pass<1>(n, p1x.data(), p1y.data(), p2x.data(),
                                p2y.data(), inf.data(), lpx, lpy, lpz, d1, d2,
                                nwin, ox.data(), oy.data(), oz.data());
            break;
        case 3:
            fold_ladder_pass<3>(n, p1x.data(), p1y.data(), p2x.data(),
                                p2y.data(), inf.data(), lpx, lpy, lpz, d1, d2,
                                nwin, ox.data(), oy.data(), oz.data());
            break;
        case 4:
            fold_ladder_pass<4>(n, p1x.data(), p1y.data(), p2x.data(),
                                p2y.data(), inf.data(), lpx, lpy, lpz, d1, d2,
                                nwin, ox.data(), oy.data(), oz.data());
            break;
        default:
            fold_ladder_pass<2>(n, p1x.data(), p1y.data(), p2x.data(),
                                p2y.data(), inf.data(), lpx, lpy, lpz, d1, d2,
                                nwin, ox.data(), oy.data(), oz.data());
            break;
    }
    std::vector<Fq> rx(n), ry(n), rz(n);
    convert_from52_batch(ox.data(), n, rx.data());
    convert_from52_batch(oy.data(), n, ry.data());
    convert_from52_batch(oz.data(), n, rz.data());
    std::vector<G1> res(n);
    for (uint64_t i = 0; i < n; ++i) {
        res[i].x = rx[i]; res[i].y = ry[i]; res[i].z = rz[i];
    }
    batch_normalize(res.data(), n);
    for (uint64_t i = 0; i < n; ++i) store_g1(res[i], out + 144 * i);
}

// out[i] = (left ? left[i] : 0) + k_i * P_i with PER-POINT GLV-split scalars.
// Same 8-wide ladder as fold_ifma, but the window digits differ per lane: the
// table entry is chosen per lane with mask selects, zero-digit lanes are
// masked out by setting the addend's Z to 0 (add_jacK's q-infinity path
// keeps the accumulator).
void batch_mul_each_ifma(const uint8_t *left_bytes,
                         const uint8_t *points, uint64_t n,
                         const uint8_t *beta48,
                         const uint8_t *k1s, const uint8_t *negs1,
                         const uint8_t *k2s, const uint8_t *negs2,
                         uint8_t *out) {
    using namespace ifma;
    if (!n) return;
    std::vector<G1> right(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, right[i]);
    batch_normalize(right.data(), n);
    Fq beta;
    load_fq(beta48, beta);
    std::vector<Fq> b1x(n), b1y(n), b2x(n), b2y(n);
    std::vector<uint8_t> inf(n);
    for (uint64_t i = 0; i < n; ++i) {
        inf[i] = g1_is_inf(right[i]);
        if (inf[i]) {
            std::memset(b1x[i].l, 0, 48); std::memset(b1y[i].l, 0, 48);
            b2x[i] = b1x[i]; b2y[i] = b1y[i];
            continue;
        }
        b1x[i] = right[i].x;
        fq_mul(right[i].x, beta, b2x[i]);
        if (negs1[i]) fq_neg(right[i].y, b1y[i]); else b1y[i] = right[i].y;
        if (negs2[i]) fq_neg(right[i].y, b2y[i]); else b2y[i] = right[i].y;
    }
    size_t ng = ((size_t)n + 7) / 8;
    std::vector<u64> p1x(ng * 64), p1y(ng * 64), p2x(ng * 64), p2y(ng * 64);
    convert_to52_batch(b1x.data(), n, p1x.data());
    convert_to52_batch(b1y.data(), n, p1y.data());
    convert_to52_batch(b2x.data(), n, p2x.data());
    convert_to52_batch(b2y.data(), n, p2y.data());
    std::vector<u64> lx, ly, lz;
    if (left_bytes) {
        std::vector<Fq> t(n);
        lx.resize(ng * 64); ly.resize(ng * 64); lz.resize(ng * 64);
        for (uint64_t i = 0; i < n; ++i) load_fq(left_bytes + 144 * i, t[i]);
        convert_to52_batch(t.data(), n, lx.data());
        for (uint64_t i = 0; i < n; ++i) load_fq(left_bytes + 144 * i + 48, t[i]);
        convert_to52_batch(t.data(), n, ly.data());
        for (uint64_t i = 0; i < n; ++i) load_fq(left_bytes + 144 * i + 96, t[i]);
        convert_to52_batch(t.data(), n, lz.data());
    }
    // per-point digits (33 windows each for both halves); the caller's scalar
    // buffers are 32-byte entries with the top 16 bytes zero (nbits <= 128)
    std::vector<int8_t> dig1(n * 33), dig2(n * 33);
    int digits[34];
    for (uint64_t i = 0; i < n; ++i) {
        recode16(k1s + 32 * i, digits);
        for (int w = 0; w < 33; ++w) dig1[i * 33 + w] = (int8_t)digits[w];
        recode16(k2s + 32 * i, digits);
        for (int w = 0; w < 33; ++w) dig2[i * 33 + w] = (int8_t)digits[w];
    }

    constexpr int K = 2;
    std::vector<u64> ox(ng * 64), oy(ng * 64), oz(ng * 64);
    Fq8 one, zero;
    broadcast8(ONE_MONT52, one);
    set_zero8(zero);
    for (size_t base = 0; base < n; base += 8 * K) {
        Fq8 B1X[K], B1Y[K], B2X[K], B2Y[K];
        __mmask8 infm[K];
        unsigned lanes[K];
        size_t lane_pt[K][8];  // point index per lane (clamped for pads)
        for (int g = 0; g < K; ++g) {
            size_t gb = base + 8 * (size_t)g;
            size_t m = gb >= n ? 0 : (n - gb < 8 ? n - gb : 8);
            lanes[g] = m == 8 ? 0xffu : ((1u << m) - 1u);
            const u64 *s1x[8], *s1y[8], *s2x[8], *s2y[8];
            infm[g] = 0;
            for (int kk = 0; kk < 8; ++kk) {
                size_t e = (size_t)kk < m ? gb + kk : base;
                lane_pt[g][kk] = e;
                s1x[kk] = p1x.data() + e * 8;
                s1y[kk] = p1y.data() + e * 8;
                s2x[kk] = p2x.data() + e * 8;
                s2y[kk] = p2y.data() + e * 8;
                if ((size_t)kk >= m || inf[e])
                    infm[g] = (__mmask8)(infm[g] | (1u << kk));
            }
            load8(s1x, B1X[g]); load8(s1y, B1Y[g]);
            load8(s2x, B2X[g]); load8(s2y, B2Y[g]);
        }
        // tables (same build as ladder_groupK)
        Jac8 tab[2][8][K];
        for (int bsel = 0; bsel < 2; ++bsel) {
            Jac8(*t)[K] = tab[bsel];
            for (int k = 0; k < K; ++k) {
                t[0][k].X = bsel ? B2X[k] : B1X[k];
                t[0][k].Y = bsel ? B2Y[k] : B1Y[k];
                select8(infm[k], zero, one, t[0][k].Z);
            }
#define CPY(d, s) for (int k = 0; k < K; ++k) t[d][k] = t[s][k]
            CPY(1, 0); dbl_jacK<K>(t[1]);
            CPY(2, 1); add_jacK<K>(t[2], t[0]);
            CPY(3, 1); dbl_jacK<K>(t[3]);
            CPY(4, 3); add_jacK<K>(t[4], t[0]);
            CPY(5, 2); dbl_jacK<K>(t[5]);
            CPY(6, 5); add_jacK<K>(t[6], t[0]);
            CPY(7, 3); dbl_jacK<K>(t[7]);
#undef CPY
        }
        Jac8 acc[K];
        for (int k = 0; k < K; ++k) set_inf_jac8(acc[k]);
        for (int w = 32; w >= 0; --w) {
            if (w != 32)
                for (int s = 0; s < 4; ++s) dbl_jacK<K>(acc);
            for (int bsel = 0; bsel < 2; ++bsel) {
                const std::vector<int8_t> &dig = bsel ? dig2 : dig1;
                Jac8 Q[K];
                bool any = false;
                for (int g = 0; g < K; ++g) {
                    __mmask8 negm = 0, zerom = 0;
                    int d_abs[8];
                    for (int kk = 0; kk < 8; ++kk) {
                        int d = dig[lane_pt[g][kk] * 33 + w];
                        if (d == 0) { zerom = (__mmask8)(zerom | (1u << kk)); d_abs[kk] = 1; }
                        else if (d < 0) { negm = (__mmask8)(negm | (1u << kk)); d_abs[kk] = -d; }
                        else d_abs[kk] = d;
                    }
                    if (zerom == 0xff) {
                        set_inf_jac8(Q[g]);
                        continue;
                    }
                    any = true;
                    // per-lane table entry select
                    Q[g] = tab[bsel][d_abs[0] - 1][g];
                    for (int e = 1; e <= 8; ++e) {
                        __mmask8 m = 0;
                        for (int kk = 0; kk < 8; ++kk)
                            if (d_abs[kk] == e) m = (__mmask8)(m | (1u << kk));
                        if (!m || e == d_abs[0]) continue;
                        const Jac8 &te = tab[bsel][e - 1][g];
                        select8(m, te.X, Q[g].X, Q[g].X);
                        select8(m, te.Y, Q[g].Y, Q[g].Y);
                        select8(m, te.Z, Q[g].Z, Q[g].Z);
                    }
                    if (negm) {
                        Fq8 yneg;
                        neg8(Q[g].Y, yneg);
                        select8(negm, yneg, Q[g].Y, Q[g].Y);
                    }
                    if (zerom)
                        select8(zerom, zero, Q[g].Z, Q[g].Z);
                }
                if (any) add_jacK<K>(acc, Q);
            }
        }
        if (left_bytes) {
            Jac8 Lp[K];
            for (int g = 0; g < K; ++g) {
                size_t gb = base + 8 * (size_t)g;
                size_t m = gb >= n ? 0 : (n - gb < 8 ? n - gb : 8);
                const u64 *slx[8], *sly[8], *slz[8];
                for (int kk = 0; kk < 8; ++kk) {
                    size_t e = (size_t)kk < m ? gb + kk : base;
                    slx[kk] = lx.data() + e * 8;
                    sly[kk] = ly.data() + e * 8;
                    slz[kk] = lz.data() + e * 8;
                }
                load8(slx, Lp[g].X); load8(sly, Lp[g].Y); load8(slz, Lp[g].Z);
            }
            add_jacK<K>(acc, Lp);
        }
        for (int g = 0; g < K; ++g) {
            if (!lanes[g]) continue;
            size_t gb = base + 8 * (size_t)g;
            u64 *dx[8], *dy[8], *dz[8];
            for (int kk = 0; kk < 8; ++kk) {
                size_t e = gb + (size_t)kk;
                size_t safe = e < n ? e : gb;
                dx[kk] = ox.data() + safe * 8;
                dy[kk] = oy.data() + safe * 8;
                dz[kk] = oz.data() + safe * 8;
            }
            store8(acc[g].X, dx, lanes[g]);
            store8(acc[g].Y, dy, lanes[g]);
            store8(acc[g].Z, dz, lanes[g]);
        }
    }
    std::vector<Fq> rx(n), ry(n), rz(n);
    convert_from52_batch(ox.data(), n, rx.data());
    convert_from52_batch(oy.data(), n, ry.data());
    convert_from52_batch(oz.data(), n, rz.data());
    std::vector<G1> res(n);
    for (uint64_t i = 0; i < n; ++i) {
        res[i].x = rx[i]; res[i].y = ry[i]; res[i].z = rz[i];
    }
    batch_normalize(res.data(), n);
    for (uint64_t i = 0; i < n; ++i) store_g1(res[i], out + 144 * i);
}

}  // namespace

#endif  // CP_HAVE_IFMA

// ---- GLV + signed-digit + batch-affine Pippenger (the flagship host MSM) ----
// Each 255-bit scalar is pre-split (host side) into k1 + k2*lambda with
// |k1|,|k2| < 2^128, doubling the point count but halving the window count
// (ark-ec's VariableBaseMSM, util.rs:19-22, has neither GLV nor batch-affine
// buckets). Signed digits in [-2^(c-1), 2^(c-1)] halve the bucket count, and
// bucket accumulation runs on affine coordinates with pass-level shared batch
// inversion (~6M per add vs ~16M Jacobian).

namespace {

int pick_window_glv(size_t npts, bool vector_chain = false) {
    // npts = 2n after the GLV split. With the IFMA vectorized chain the
    // per-bucket cost drops from ~27 scalar muls to ~4 mul-equivalents.
    if (const char *env = std::getenv("CP_MSM_C")) {
        int c = atoi(env);
        if (c >= 4 && c <= 16) return c;
    }
    double chain_cost = vector_chain ? 4.0 : 27.0;
    double best = 1e30;
    int bestc = 6;
    // cap 13: the top GLV window keeps >= 12 bits (129 - 9*13), and the
    // per-window bucket region stays cache-resident for the scatter phase
    for (int c = 4; c <= 13; ++c) {
        double w = (129.0 + c - 1.0) / c;
        double cost = w * ((double)npts * 6.0 +
                           (double)(1 << (c - 1)) * chain_cost);
        if (cost < best) { best = cost; bestc = c; }
    }
    return bestc;
}

// 16-byte little-endian halves; negs flag the halves' signs.
void msm_glv_ba(const G1 *jac_pts, size_t n,
                const uint8_t *k1s, const uint8_t *negs1,
                const uint8_t *k2s, const uint8_t *negs2,
                const Fq &beta_mont, G1 &out) {
    // 1. normalise inputs once; build 2n affine points (second half = endo)
    std::vector<G1> norm(jac_pts, jac_pts + n);
    batch_normalize(norm.data(), n);
    size_t npts = 2 * n;
    std::vector<AffPt> pts(npts);
    for (size_t i = 0; i < n; ++i) {
        bool inf = g1_is_inf(norm[i]);
        pts[i].inf = inf;
        pts[n + i].inf = inf;
        if (inf) continue;
        pts[i].x = norm[i].x;
        pts[n + i].y = pts[i].y = norm[i].y;
        fq_mul(norm[i].x, beta_mont, pts[n + i].x);  // phi(x,y) = (beta*x, y)
        if (negs1[i]) fq_neg(norm[i].y, pts[i].y);
        if (negs2[i]) fq_neg(norm[i].y, pts[n + i].y);
    }

    int c = pick_window_glv(npts);
    int windows = (129 + c - 1) / c;
    size_t nb = (size_t)1 << (c - 1);  // buckets for |digit| in 1..2^(c-1)
    size_t nslots = (size_t)windows * nb;

    // 2. signed-digit recode -> flat entries, counting-sorted by slot
    std::vector<uint32_t> counts(nslots + 1, 0);
    // entry payload: point index (<2^31) | neg flag in the top bit
    struct Ent { uint32_t slot; uint32_t pi; };
    std::vector<Ent> raw;
    raw.reserve(npts * (size_t)((128 + c - 1) / c));
    const int half = 1 << (c - 1);
    const unsigned mask = (1u << c) - 1u;
    for (size_t i = 0; i < npts; ++i) {
        const uint8_t *s = (i < n) ? k1s + 16 * i : k2s + 16 * (i - n);
        unsigned carry = 0;
        for (int w = 0; w < windows; ++w) {
            int bit_lo = w * c;
            unsigned v = carry;
            if (bit_lo < 128) {
                // gather up to c bits from the 16-byte LE value
                int byte = bit_lo >> 3, off = bit_lo & 7;
                uint64_t chunk = 0;
                for (int b = 0; b < 3 && byte + b < 16; ++b)
                    chunk |= (uint64_t)s[byte + b] << (8 * b);
                v += (unsigned)((chunk >> off) & mask);
            }
            int d;
            if (v > (unsigned)half) { d = (int)v - (1 << c); carry = 1; }
            else { d = (int)v; carry = 0; }
            if (d != 0) {
                uint32_t slot = (uint32_t)w * (uint32_t)nb +
                                (uint32_t)(d < 0 ? -d : d) - 1u;
                uint32_t pi = (uint32_t)i | (d < 0 ? 0x80000000u : 0u);
                raw.push_back({slot, pi});
                counts[slot + 1]++;
            }
        }
    }
    for (size_t sidx = 1; sidx <= nslots; ++sidx) counts[sidx] += counts[sidx - 1];
    std::vector<uint32_t> sorted(raw.size());
    {
        std::vector<uint32_t> cur(counts.begin(), counts.end() - 1);
        for (const Ent &e : raw) sorted[cur[e.slot]++] = e.pi;
    }

    // 3. bucket phase. Slot occupancy can be badly skewed (e.g. the top
    //    carry window drops ~half the points into bucket |1|), which would
    //    make the pass count O(max occupancy). Split any hot slot into
    //    virtual sub-accumulators of <= T entries each, run the passes over
    //    virtual slots, then tree-merge the sub-accumulators (log passes).
    const size_t T = std::max<size_t>(
        8, 2 * (raw.size() / std::max<size_t>(nslots, 1) + 1));
    std::vector<uint32_t> vbase(nslots), vspan(nslots);
    size_t nv = 0, max_span = 0;
    for (size_t s = 0; s < nslots; ++s) {
        size_t occ = counts[s + 1] - counts[s];
        size_t span = (occ + T - 1) / T;
        vbase[s] = (uint32_t)nv;
        vspan[s] = (uint32_t)span;
        nv += span;
        if (span > max_span) max_span = span;
    }
    std::vector<AffPt> buckets(nv);
    for (auto &b : buckets) b.inf = true;
    std::vector<uint32_t> live, off(nv), vend(nv);
    std::vector<uint32_t> split_slots;  // parents with >1 sub-accumulator
    for (size_t s = 0; s < nslots; ++s) {
        for (uint32_t ch = 0; ch < vspan[s]; ++ch) {
            uint32_t v = vbase[s] + ch;
            off[v] = counts[s] + ch * (uint32_t)T;
            vend[v] = std::min<uint32_t>(off[v] + (uint32_t)T, counts[s + 1]);
            live.push_back(v);
        }
        if (vspan[s] > 1) split_slots.push_back((uint32_t)s);
    }
    std::vector<int64_t> slots, pis;
    std::vector<uint8_t> negs;
    std::vector<Fq> denoms;
    std::vector<int> kinds;
    std::vector<uint32_t> nxt;
    while (!live.empty()) {
        slots.clear(); pis.clear(); negs.clear(); nxt.clear();
        for (uint32_t v : live) {
            uint32_t e = sorted[off[v]++];
            slots.push_back((int64_t)v);
            pis.push_back((int64_t)(e & 0x7fffffffu));
            negs.push_back((uint8_t)(e >> 31));
            if (off[v] < vend[v]) nxt.push_back(v);
        }
        affine_add_pass(buckets.data(), slots.data(), pts.data(), pis.data(),
                        slots.size(), denoms, kinds, negs.data());
        live.swap(nxt);
    }
    // tree-merge sub-accumulators into each parent's first virtual slot;
    // each pass merges disjoint (target, source) pairs so it stays batchable
    for (size_t stride = 1; stride < max_span; stride *= 2) {
        slots.clear(); pis.clear();
        for (uint32_t s : split_slots) {
            for (size_t k = 0; k + stride < vspan[s]; k += 2 * stride) {
                slots.push_back((int64_t)(vbase[s] + k));
                pis.push_back((int64_t)(vbase[s] + k + stride));
            }
        }
        if (!slots.empty())
            affine_add_pass(buckets.data(), slots.data(), buckets.data(),
                            pis.data(), slots.size(), denoms, kinds, nullptr);
    }

    // 4. per-window running/weighted chains (mixed adds: buckets are affine),
    //    then the Horner doubling ladder across windows.
    g1_set_inf(out);
    G1 t;
    for (int w = windows - 1; w >= 0; --w) {
        for (int k = 0; k < c; ++k) g1_double(out, out);
        size_t hi = 0;
        for (size_t b = nb; b-- > 0;) {
            size_t s = (size_t)w * nb + b;
            if (vspan[s] && !buckets[vbase[s]].inf) { hi = b + 1; break; }
        }
        if (!hi) continue;
        G1 running, wsum;
        g1_set_inf(running);
        g1_set_inf(wsum);
        for (size_t b = hi; b-- > 0;) {
            size_t s = (size_t)w * nb + b;
            static const AffPt kInf = {{{0}}, {{0}}, true};
            const AffPt &bk = vspan[s] ? buckets[vbase[s]] : kInf;
            if (!bk.inf) {
                G1 q;
                q.x = bk.x;
                q.y = bk.y;
                std::memcpy(q.z.l, ONE_MONT, 48);
                g1_add(running, q, t);
                running = t;
            }
            g1_add(wsum, running, t);
            wsum = t;
        }
        g1_add(out, wsum, t);
        out = t;
    }
}

#if CP_HAVE_IFMA

// scalar helper: batch inversion of n mont64 field elements in place
void batch_inv_mont64(Fq *v, size_t n) {
    if (!n) return;
    std::vector<Fq> prefix(n);
    Fq acc;
    std::memcpy(acc.l, ONE_MONT, 48);
    for (size_t i = 0; i < n; ++i) {
        prefix[i] = acc;
        fq_mul(acc, v[i], acc);
    }
    Fq inv;
    fq_inv(acc, inv);
    for (size_t i = n; i-- > 0;) {
        Fq vi;
        fq_mul(inv, prefix[i], vi);
        fq_mul(inv, v[i], inv);
        v[i] = vi;
    }
}

// invert all 8 lanes of `chains[nchains]` (mont52) through one scalar
// inversion: extract -> mont64 -> batch invert -> back
void invert_lanes52(const ifma::Fq8 *chains, size_t nchains, ifma::Fq8 *out) {
    size_t total = nchains * 8;
    std::vector<u64> packed(total * 8);
    {
        u64 *dsts[8];
        for (size_t c = 0; c < nchains; ++c) {
            for (int k = 0; k < 8; ++k) dsts[k] = packed.data() + (c * 8 + k) * 8;
            ifma::store8(chains[c], dsts);
        }
    }
    std::vector<Fq> vals(total);
    convert_from52_batch(packed.data(), total, vals.data());
    batch_inv_mont64(vals.data(), total);
    convert_to52_batch(vals.data(), total, packed.data());
    {
        const u64 *srcs[8];
        for (size_t c = 0; c < nchains; ++c) {
            for (int k = 0; k < 8; ++k) srcs[k] = packed.data() + (c * 8 + k) * 8;
            ifma::load8(srcs, out[c]);
        }
    }
}

// scalar mont52 negate: dst = p - src (src canonical and nonzero; curve
// points always have y != 0 since |E(Fq)| is odd)
inline void neg52_scalar(const u64 *src, u64 *dst) {
    const u64 m52 = (1ULL << 52) - 1;
    u64 borrow = 0;
    for (int j = 0; j < 8; ++j) {
        u64 x = P52[j] - src[j] - borrow;
        borrow = x >> 63;
        dst[j] = x & m52;
    }
}

// one recoded MSM entry: bucket slot + point index (bit 31 = subtract,
// i.e. negate the point's y when it enters the bucket)
struct SEnt {
    uint32_t slot;
    uint32_t pi;
};

// Generic 8-wide batched affine addition: for each op e in [0, nops),
// opfn(e, ax, ay, bx, by, negb, dx, dy) supplies packed-52 source pointers
// for A and B (both finite points), whether B's y is negated on the fly,
// and destination pointers; the core computes D = A + B for every op,
// sharing one modular inversion per internal 4096-op chunk (two-sweep
// prefix-product, NCH interleaved chains). A == B lanes take the doubling
// formula; A == -B lanes skip the store and call canfn(e) so the caller
// can mark the result infinity. Ops must be independent: no op's
// destination may alias another op's source. opfn is called multiple
// times per op (prefetch + forward + backward) and must be pure.
template <class OpFn, class CanFn>
void batched_affine_rounds(size_t nops_total, OpFn opfn, CanFn canfn) {
    using namespace ifma;
    if (!nops_total) return;
    // internal chunking: one shared inversion per CHUNK ops, and a chunk's
    // gathered operands are cached in transposed (Fq8) form so the backward
    // sweep reads sequentially instead of re-gathering random lanes
    constexpr size_t CHUNK = 4096;
    constexpr size_t NCH = 4;
    constexpr size_t MAXG = CHUNK / 8;
    static std::vector<Fq8> wsAX, wsAY, wsBX, wsBY, pref;
    wsAX.resize(MAXG);
    wsAY.resize(MAXG);
    wsBX.resize(MAXG);
    wsBY.resize(MAXG);
    pref.resize(MAXG);
    uint8_t gdbl[MAXG], gcan[MAXG];
    Fq8 one52;
    broadcast8(ONE_MONT52, one52);

    for (size_t cbase = 0; cbase < nops_total; cbase += CHUNK) {
        size_t nops = nops_total - cbase < CHUNK ? nops_total - cbase : CHUNK;
        size_t ngroups = (nops + 7) / 8;
        size_t nch = ngroups < NCH ? ngroups : NCH;
        Fq8 run[NCH], tinv[NCH];
        for (size_t ci = 0; ci < nch; ++ci) run[ci] = one52;

        // forward: gather + classify lanes, cache operands, build the
        // interleaved denominator chains
        for (size_t gidx = 0; gidx < ngroups; ++gidx) {
            // prefetch the A-side (typically random) lanes two groups out
            if (gidx + 2 < ngroups) {
                size_t pb = cbase + (gidx + 2) * 8;
                for (int k = 0; k < 8; ++k) {
                    size_t e = pb + k < cbase + nops ? pb + k : pb;
                    const u64 *ax, *ay, *bx, *by;
                    u64 *dx, *dy;
                    bool negb = false;
                    opfn(e, ax, ay, bx, by, negb, dx, dy);
                    _mm_prefetch((const char *)ax, _MM_HINT_T0);
                    _mm_prefetch((const char *)ay, _MM_HINT_T0);
                }
            }
            const u64 *sax[8], *say[8], *sbx[8], *sby[8];
            __mmask8 negm = 0;
            size_t base = gidx * 8;
            for (int k = 0; k < 8; ++k) {
                size_t e = cbase + (base + k < nops ? base + k : base);
                const u64 *ax, *ay, *bx, *by;
                u64 *dx, *dy;
                bool negb = false;
                opfn(e, ax, ay, bx, by, negb, dx, dy);
                sax[k] = ax;
                say[k] = ay;
                sbx[k] = bx;
                sby[k] = by;
                if (base + k < nops && negb)
                    negm = (__mmask8)(negm | (1u << k));
            }
            __mmask8 padm = nops - base < 8
                                ? (__mmask8)(0xffu << (nops - base))
                                : (__mmask8)0;
            Fq8 AX, AY, BX, BY, den;
            load8(sax, AX);
            load8(say, AY);
            load8(sbx, BX);
            load8(sby, BY);
            if (negm) {
                Fq8 yn;
                neg8(BY, yn);
                select8(negm, yn, BY, BY);
            }
            wsAX[gidx] = AX;
            wsAY[gidx] = AY;
            wsBX[gidx] = BX;
            wsBY[gidx] = BY;
            __mmask8 live = (__mmask8)~padm;
            __mmask8 eqx = (__mmask8)(eq8(AX, BX) & live);
            __mmask8 eqy = eq8(AY, BY);
            __mmask8 dblm = (__mmask8)(eqx & eqy);
            __mmask8 canm = (__mmask8)(eqx & ~eqy);  // A + (-A)
            gdbl[gidx] = dblm;
            gcan[gidx] = canm;
            sub8(BX, AX, den);
            if (dblm) {
                Fq8 d2;
                dbl8(AY, d2);
                select8(dblm, d2, den, den);
            }
            __mmask8 skipm = (__mmask8)(canm | padm);
            if (skipm) select8(skipm, one52, den, den);
            size_t ci = (gidx & 3) % nch;
            pref[gidx] = run[ci];
            montmul8(run[ci], den, run[ci]);
        }
        invert_lanes52(run, nch, tinv);
        // backward: reconstruct each op's inverse from the cached operands,
        // apply the formulas, store through the op's destination pointers
        for (size_t gidx = ngroups; gidx-- > 0;) {
            const Fq8 &AX = wsAX[gidx], &AY = wsAY[gidx];
            const Fq8 &BX = wsBX[gidx], &BY = wsBY[gidx];
            __mmask8 dblm = (__mmask8)gdbl[gidx], canm = (__mmask8)gcan[gidx];
            size_t base = gidx * 8;
            __mmask8 padm = nops - base < 8
                                ? (__mmask8)(0xffu << (nops - base))
                                : (__mmask8)0;
            u64 *dx8[8], *dy8[8];
            unsigned lanes = 0;
            for (int k = 0; k < 8; ++k) {
                size_t e = cbase + (base + k < nops ? base + k : base);
                const u64 *ax, *ay, *bx, *by;
                u64 *dx, *dy;
                bool negb = false;
                opfn(e, ax, ay, bx, by, negb, dx, dy);
                dx8[k] = dx;
                dy8[k] = dy;
                if (base + k < nops && !((canm >> k) & 1)) lanes |= 1u << k;
                _mm_prefetch((const char *)dx, _MM_HINT_T0);
                _mm_prefetch((const char *)dy, _MM_HINT_T0);
            }
            Fq8 den, num, inv;
            sub8(BX, AX, den);
            if (dblm) {
                Fq8 d2;
                dbl8(AY, d2);
                select8(dblm, d2, den, den);
            }
            __mmask8 skipm = (__mmask8)(canm | padm);
            if (skipm) select8(skipm, one52, den, den);
            size_t ci = (gidx & 3) % nch;
            montmul8(tinv[ci], pref[gidx], inv);
            montmul8(tinv[ci], den, tinv[ci]);
            sub8(BY, AY, num);
            if (dblm) {
                Fq8 t, t3;
                sqr8(AX, t);
                dbl8(t, t3);
                add8(t3, t, t3);  // 3x^2
                select8(dblm, t3, num, num);
            }
            Fq8 lam, x3, y3, t;
            montmul8(num, inv, lam);
            sqr8(lam, x3);
            sub8(x3, AX, x3);
            sub8(x3, BX, x3);
            sub8(AX, x3, t);
            montmul8(lam, t, y3);
            sub8(y3, AY, y3);
            store8(x3, dx8, lanes);
            store8(y3, dy8, lanes);
            if (canm)
                for (int k = 0; k < 8; ++k)
                    if ((canm >> k) & 1) canfn(cbase + base + k);
        }
    }
}

// IFMA bucket accumulation, scatter form: stream the recoded entries in
// point order and add each one directly into its bucket with 8-wide affine
// additions (batched_affine_rounds), sharing one modular inversion per
// batch of B pending adds. Compared to a per-slot tree reduction this
// never materializes per-entry work arrays: point reads are sequential in
// the entry stream (each point's windows are adjacent), and the only
// random traffic is the packed-52 bucket array (a few MB at production
// window sizes — cache resident). Conflict rule: a slot can host at most
// one pending add per batch (epoch stamps); colliding entries go to an
// overflow list. The overflow is NOT re-streamed (the top window's digits
// are few — its slots collide thousands of times, making one-at-a-time
// retries quadratic); instead it is counting-sorted by slot and pair-
// reduced level by level — each level one batched_affine_rounds call —
// which absorbs any multiplicity in log2(max-per-slot) levels. The final
// per-slot survivors merge into the buckets with one more batched pass.
// Output: packed-52 affine bucket heads (bkx/bky/binf).
void ifma_bucket_scatter(const u64 *px52, const u64 *py52,
                         const std::vector<SEnt> &entries, size_t nslots,
                         std::vector<u64> &bkx, std::vector<u64> &bky,
                         std::vector<uint8_t> &binf) {
    using namespace ifma;
    bkx.assign(nslots * 8, 0);
    bky.assign(nslots * 8, 0);
    binf.assign(nslots, 1);
    constexpr size_t B = 4096;  // pending adds per shared inversion
    static_assert(B % 8 == 0, "batch must fill whole lane groups");
    std::vector<uint32_t> bslot(B), bpi(B);
    std::vector<uint32_t> epoch(nslots, 0);
    std::vector<SEnt> overflow;
    uint32_t bid = 1;
    size_t npend = 0;

    auto flush = [&]() {
        size_t nops = npend;
        npend = 0;
        ++bid;
        batched_affine_rounds(
            nops,
            [&](size_t e, const u64 *&ax, const u64 *&ay, const u64 *&bx,
                const u64 *&by, bool &negb, u64 *&dx, u64 *&dy) {
                uint32_t s = bslot[e], ent = bpi[e];
                uint32_t pi = ent & 0x7fffffffu;
                ax = bkx.data() + (size_t)s * 8;
                ay = bky.data() + (size_t)s * 8;
                bx = px52 + (size_t)pi * 8;
                by = py52 + (size_t)pi * 8;
                negb = (ent >> 31) != 0;
                dx = bkx.data() + (size_t)s * 8;
                dy = bky.data() + (size_t)s * 8;
            },
            [&](size_t e) { binf[bslot[e]] = 1; });
    };

    auto push = [&](SEnt e) {
        uint32_t s = e.slot;
        if (binf[s]) {
            uint32_t pi = e.pi & 0x7fffffffu;
            std::memcpy(bkx.data() + (size_t)s * 8, px52 + (size_t)pi * 8, 64);
            if (e.pi >> 31)
                neg52_scalar(py52 + (size_t)pi * 8,
                             bky.data() + (size_t)s * 8);
            else
                std::memcpy(bky.data() + (size_t)s * 8, py52 + (size_t)pi * 8,
                            64);
            binf[s] = 0;
            return;
        }
        if (epoch[s] == bid) {
            overflow.push_back(e);
            return;
        }
        epoch[s] = bid;
        bslot[npend] = s;
        bpi[npend] = e.pi;
        if (++npend == B) flush();
    };

    for (const SEnt &e : entries) push(e);
    flush();

    // ---- overflow: counting-sort by slot, materialize signed copies,
    //      pair-reduce each slot's segment, merge survivors into buckets --
    size_t no = overflow.size();
    if (no) {
        std::vector<uint32_t> counts(nslots + 1, 0);
        for (const SEnt &e : overflow) counts[e.slot + 1]++;
        for (size_t s = 1; s <= nslots; ++s) counts[s] += counts[s - 1];
        std::vector<u64> wx(no * 8), wy(no * 8);
        std::vector<uint8_t> winf(no, 0);
        {
            std::vector<uint32_t> cur(counts.begin(), counts.end() - 1);
            for (const SEnt &e : overflow) {
                uint32_t k = cur[e.slot]++;
                uint32_t pi = e.pi & 0x7fffffffu;
                std::memcpy(wx.data() + (size_t)k * 8, px52 + (size_t)pi * 8,
                            64);
                if (e.pi >> 31)
                    neg52_scalar(py52 + (size_t)pi * 8,
                                 wy.data() + (size_t)k * 8);
                else
                    std::memcpy(wy.data() + (size_t)k * 8,
                                py52 + (size_t)pi * 8, 64);
            }
        }
        // slots with overflow (sparse relative to nslots)
        std::vector<uint32_t> active;
        for (size_t s = 0; s < nslots; ++s)
            if (counts[s + 1] > counts[s]) active.push_back((uint32_t)s);

        struct Pair {
            uint32_t i, j;
        };
        std::vector<Pair> pairs;
        std::vector<uint32_t> nxt;
        size_t stride = 1;
        while (!active.empty()) {
            pairs.clear();
            nxt.clear();
            for (uint32_t s : active) {
                uint32_t start = counts[s], end = counts[s + 1];
                for (uint32_t k = start; k + stride < end; k += 2 * stride) {
                    uint32_t i = k, j = k + (uint32_t)stride;
                    if (winf[j]) continue;
                    if (winf[i]) {
                        std::memcpy(wx.data() + (size_t)i * 8,
                                    wx.data() + (size_t)j * 8, 64);
                        std::memcpy(wy.data() + (size_t)i * 8,
                                    wy.data() + (size_t)j * 8, 64);
                        winf[i] = 0;
                        winf[j] = 1;
                        continue;
                    }
                    pairs.push_back({i, j});
                }
                if (counts[s + 1] - counts[s] > 2 * stride)
                    nxt.push_back(s);
            }
            batched_affine_rounds(
                pairs.size(),
                [&](size_t e, const u64 *&ax, const u64 *&ay, const u64 *&bx,
                    const u64 *&by, bool &negb, u64 *&dx, u64 *&dy) {
                    const Pair &pr = pairs[e];
                    ax = wx.data() + (size_t)pr.i * 8;
                    ay = wy.data() + (size_t)pr.i * 8;
                    bx = wx.data() + (size_t)pr.j * 8;
                    by = wy.data() + (size_t)pr.j * 8;
                    negb = false;
                    dx = wx.data() + (size_t)pr.i * 8;
                    dy = wy.data() + (size_t)pr.i * 8;
                },
                [&](size_t e) { winf[pairs[e].i] = 1; });
            active.swap(nxt);
            stride *= 2;
        }
        // survivors (one head per nonempty slot, at the segment start)
        std::vector<uint32_t> hs_slot, hs_idx;
        for (size_t s = 0; s < nslots; ++s) {
            if (counts[s + 1] == counts[s]) continue;
            uint32_t k = counts[s];
            if (winf[k]) continue;
            if (binf[s]) {
                std::memcpy(bkx.data() + s * 8, wx.data() + (size_t)k * 8,
                            64);
                std::memcpy(bky.data() + s * 8, wy.data() + (size_t)k * 8,
                            64);
                binf[s] = 0;
            } else {
                hs_slot.push_back((uint32_t)s);
                hs_idx.push_back(k);
            }
        }
        batched_affine_rounds(
            hs_slot.size(),
            [&](size_t e, const u64 *&ax, const u64 *&ay, const u64 *&bx,
                const u64 *&by, bool &negb, u64 *&dx, u64 *&dy) {
                uint32_t s = hs_slot[e], k = hs_idx[e];
                ax = bkx.data() + (size_t)s * 8;
                ay = bky.data() + (size_t)s * 8;
                bx = wx.data() + (size_t)k * 8;
                by = wy.data() + (size_t)k * 8;
                negb = false;
                dx = bkx.data() + (size_t)s * 8;
                dy = bky.data() + (size_t)s * 8;
            },
            [&](size_t e) { binf[hs_slot[e]] = 1; });
    }
}

// Bucket chains vectorized ACROSS windows: lane (k*8 + j) of instance k runs
// window wg0*8.. 's running/weighted sums; nb sequential steps of two
// Jacobian adds each, K instances interleaved for latency hiding.
template <int K>
void chain_windows(const u64 *bkx, const u64 *bky,
                   const std::vector<uint8_t> &binf, size_t nb, int windows,
                   int wg0, Jac8 *wsum) {
    using namespace ifma;
    Fq8 one, zero;
    broadcast8(ONE_MONT52, one);
    set_zero8(zero);
    Jac8 run[K];
    for (int k = 0; k < K; ++k) { set_inf_jac8(run[k]); set_inf_jac8(wsum[k]); }
    for (ptrdiff_t b = (ptrdiff_t)nb - 1; b >= 0; --b) {
        Jac8 Q[K];
        for (int k = 0; k < K; ++k) {
            const u64 *sx[8], *sy[8];
            __mmask8 infm = 0;
            for (int lane = 0; lane < 8; ++lane) {
                int w = (wg0 + k) * 8 + lane;
                size_t slot = w < windows ? (size_t)w * nb + (size_t)b : 0;
                sx[lane] = bkx + slot * 8;
                sy[lane] = bky + slot * 8;
                if (w >= windows || binf[slot])
                    infm = (__mmask8)(infm | (1u << lane));
            }
            load8(sx, Q[k].X);
            load8(sy, Q[k].Y);
            select8(infm, zero, one, Q[k].Z);
        }
        add_jacK<K>(run, Q);
        add_jacK<K>(wsum, run);
    }
}

// full MSM on the IFMA path: GLV split done by the caller, recode + schedule
// identical to msm_glv_ba, bucket phase vectorized. Batched form: `msm_id`
// (nullable) assigns each input point to one of `n_msms` independent MSMs
// that share the bucket tree, the inversion tails and the vectorized chains
// (each MSM gets its own window group in the slot space) — this amortizes the
// fixed costs across e.g. the 4 MSMs of one IPA folding round
// (inner_product_argument.rs:158-161).
void msm_glv_ifma_multi(const G1 *jac_pts, size_t n,
                        const uint8_t *k1s, const uint8_t *negs1,
                        const uint8_t *k2s, const uint8_t *negs2,
                        const Fq &beta_mont, const uint32_t *msm_id,
                        size_t n_msms, G1 *outs) {
    std::vector<G1> norm(jac_pts, jac_pts + n);
    batch_normalize(norm.data(), n);
    size_t npts = 2 * n;
    // affine coords in mont64 (for endo + sign below), then packed mont52
    std::vector<Fq> ax(npts), ay(npts);
    std::vector<uint8_t> pinf(npts);
    for (size_t i = 0; i < n; ++i) {
        bool inf = g1_is_inf(norm[i]);
        pinf[i] = pinf[n + i] = inf;
        if (inf) {
            std::memset(ax[i].l, 0, 48); std::memset(ay[i].l, 0, 48);
            ax[n + i] = ax[i]; ay[n + i] = ay[i];
            continue;
        }
        ax[i] = norm[i].x;
        ay[n + i] = ay[i] = norm[i].y;
        fq_mul(norm[i].x, beta_mont, ax[n + i]);
        if (negs1[i]) fq_neg(norm[i].y, ay[i]);
        if (negs2[i]) fq_neg(norm[i].y, ay[n + i]);
    }
    std::vector<u64> px52(npts * 8), py52(npts * 8);
    convert_to52_batch(ax.data(), npts, px52.data());
    convert_to52_batch(ay.data(), npts, py52.data());

    int c = pick_window_glv((npts + n_msms - 1) / n_msms,
                            /*vector_chain=*/true);
    int windows = (129 + c - 1) / c;
    size_t nb = (size_t)1 << (c - 1);
    size_t nslots = n_msms * (size_t)windows * nb;

    // signed-digit recode -> flat entries in point order (same recode as
    // msm_glv_ba, but sign baked into the entry's top bit only — negs were
    // consumed into ay already, so here the entry sign tracks the DIGIT
    // sign). No sort: the scatter phase consumes the stream directly.
    std::vector<SEnt> raw;
    raw.reserve(npts * (size_t)((128 + c - 1) / c));
    const int half = 1 << (c - 1);
    const unsigned mask = (1u << c) - 1u;
    for (size_t i = 0; i < npts; ++i) {
        if (pinf[i]) continue;  // the identity contributes nothing
        const uint8_t *s = (i < n) ? k1s + 16 * i : k2s + 16 * (i - n);
        uint32_t mid = msm_id ? msm_id[i < n ? i : i - n] : 0;
        uint32_t wbase = mid * (uint32_t)windows;
        unsigned carry = 0;
        for (int w = 0; w < windows; ++w) {
            int bit_lo = w * c;
            unsigned v = carry;
            if (bit_lo < 128) {
                int byte = bit_lo >> 3, off = bit_lo & 7;
                uint64_t chunk = 0;
                for (int b = 0; b < 3 && byte + b < 16; ++b)
                    chunk |= (uint64_t)s[byte + b] << (8 * b);
                v += (unsigned)((chunk >> off) & mask);
            }
            int d;
            if (v > (unsigned)half) { d = (int)v - (1 << c); carry = 1; }
            else { d = (int)v; carry = 0; }
            if (d != 0) {
                uint32_t slot = (wbase + (uint32_t)w) * (uint32_t)nb +
                                (uint32_t)(d < 0 ? -d : d) - 1u;
                uint32_t pi = (uint32_t)i | (d < 0 ? 0x80000000u : 0u);
                raw.push_back({slot, pi});
            }
        }
    }

    std::vector<u64> bkx, bky;
    std::vector<uint8_t> binf;
    ifma_bucket_scatter(px52.data(), py52.data(), raw, nslots, bkx, bky, binf);

    // running/weighted bucket chains, 8 windows per lane-group, instances
    // interleaved; then extras, then the scalar Horner ladder over windows.
    // All n_msms * windows window groups chain together (fuller lanes).
    int windows_total = (int)n_msms * windows;
    int wg_total = (windows_total + 7) / 8;
    std::vector<Jac8> wsum_v(wg_total);
    for (int wg0 = 0; wg0 < wg_total;) {
        int rem = wg_total - wg0;
        if (rem >= 3) {
            chain_windows<3>(bkx.data(), bky.data(), binf, nb, windows_total,
                             wg0, wsum_v.data() + wg0);
            wg0 += 3;
        } else if (rem == 2) {
            chain_windows<2>(bkx.data(), bky.data(), binf, nb, windows_total,
                             wg0, wsum_v.data() + wg0);
            wg0 += 2;
        } else {
            chain_windows<1>(bkx.data(), bky.data(), binf, nb, windows_total,
                             wg0, wsum_v.data() + wg0);
            wg0 += 1;
        }
    }
    // extract the per-window sums to mont64 Jacobian
    std::vector<u64> sxp((size_t)wg_total * 64), syp((size_t)wg_total * 64),
        szp((size_t)wg_total * 64);
    for (int wg = 0; wg < wg_total; ++wg) {
        u64 *dx[8], *dy[8], *dz[8];
        for (int lane = 0; lane < 8; ++lane) {
            size_t e = (size_t)wg * 8 + lane;
            dx[lane] = sxp.data() + e * 8;
            dy[lane] = syp.data() + e * 8;
            dz[lane] = szp.data() + e * 8;
        }
        ifma::store8(wsum_v[wg].X, dx);
        ifma::store8(wsum_v[wg].Y, dy);
        ifma::store8(wsum_v[wg].Z, dz);
    }
    size_t nw8 = (size_t)wg_total * 8;
    std::vector<Fq> sxf(nw8), syf(nw8), szf(nw8);
    convert_from52_batch(sxp.data(), nw8, sxf.data());
    convert_from52_batch(syp.data(), nw8, syf.data());
    convert_from52_batch(szp.data(), nw8, szf.data());
    std::vector<G1> wsums(windows_total);
    for (int w = 0; w < windows_total; ++w) {
        wsums[w].x = sxf[w];
        wsums[w].y = syf[w];
        wsums[w].z = szf[w];
    }
    // per-MSM Horner ladders over each window group
    G1 t;
    for (size_t mi = 0; mi < n_msms; ++mi) {
        G1 &out = outs[mi];
        g1_set_inf(out);
        for (int w = windows - 1; w >= 0; --w) {
            for (int k = 0; k < c; ++k) g1_double(out, out);
            const G1 &s_w = wsums[mi * windows + w];
            if (!g1_is_inf(s_w)) { g1_add(out, s_w, t); out = t; }
        }
    }
}

inline void msm_glv_ifma(const G1 *jac_pts, size_t n,
                         const uint8_t *k1s, const uint8_t *negs1,
                         const uint8_t *k2s, const uint8_t *negs2,
                         const Fq &beta_mont, G1 &out) {
    msm_glv_ifma_multi(jac_pts, n, k1s, negs1, k2s, negs2, beta_mont,
                       nullptr, 1, &out);
}

#endif  // CP_HAVE_IFMA

}  // namespace

extern "C" {

void cp_msm_glv(const uint8_t *points, uint64_t n,
                const uint8_t *k1s, const uint8_t *negs1,
                const uint8_t *k2s, const uint8_t *negs2,
                const uint8_t *beta48, uint8_t *out) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, pts[i]);
    Fq beta;
    load_fq(beta48, beta);
    G1 r;
#if CP_HAVE_IFMA
    if (!std::getenv("CP_NO_IFMA"))
        msm_glv_ifma(pts.data(), n, k1s, negs1, k2s, negs2, beta, r);
    else
        msm_glv_ba(pts.data(), n, k1s, negs1, k2s, negs2, beta, r);
#else
    msm_glv_ba(pts.data(), n, k1s, negs1, k2s, negs2, beta, r);
#endif
    store_g1(r, out);
}

// Batched MSMs sharing one bucket tree; `msm_id` assigns each point to its
// MSM, `outs` receives n_msms results. Requires IFMA (caller checks
// cp_ifma_available); falls back to per-MSM msm_glv_ba otherwise.
void cp_msm_glv_many(const uint8_t *points, uint64_t n,
                     const uint8_t *k1s, const uint8_t *negs1,
                     const uint8_t *k2s, const uint8_t *negs2,
                     const uint8_t *beta48, const uint32_t *msm_id,
                     uint64_t n_msms, uint8_t *outs) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, pts[i]);
    Fq beta;
    load_fq(beta48, beta);
    std::vector<G1> res(n_msms);
#if CP_HAVE_IFMA
    if (!std::getenv("CP_NO_IFMA")) {
        msm_glv_ifma_multi(pts.data(), n, k1s, negs1, k2s, negs2, beta,
                           msm_id, n_msms, res.data());
        for (uint64_t m = 0; m < n_msms; ++m) store_g1(res[m], outs + 144 * m);
        return;
    }
#endif
    // scalar fallback: run each MSM separately
    for (uint64_t m = 0; m < n_msms; ++m) {
        std::vector<G1> sub;
        std::vector<uint8_t> sk1, sk2, sn1, sn2;
        for (uint64_t i = 0; i < n; ++i) {
            if (msm_id[i] != m) continue;
            sub.push_back(pts[i]);
            sk1.insert(sk1.end(), k1s + 16 * i, k1s + 16 * (i + 1));
            sk2.insert(sk2.end(), k2s + 16 * i, k2s + 16 * (i + 1));
            sn1.push_back(negs1[i]);
            sn2.push_back(negs2[i]);
        }
        G1 r2;
        if (sub.empty()) g1_set_inf(r2);
        else msm_glv_ba(sub.data(), sub.size(), sk1.data(), sn1.data(),
                        sk2.data(), sn2.data(), beta, r2);
        store_g1(r2, outs + 144 * m);
    }
}

}  // extern "C"

// ---- batch G1 decompression + validation (ZCash 48-byte format) ----
// The whisk byte boundary (whisk.rs:265-341) decompresses hundreds of points
// per call: sqrt = x^((q+1)/4) (q = 3 mod 4) batched 8-wide on the IFMA
// engine, subgroup check = [r]P with a shared-digit 8-wide Jacobian ladder.

namespace {

#if CP_HAVE_IFMA

// vertical batch pow by the fixed public exponent (q+1)/4 for K independent
// 8-lane groups in lockstep (the exponent is shared, so each sqr/mul step
// runs K instances back-to-back — a single group is latency-bound on the
// montmul dependency chain and leaves the IFMA ports ~3/4 idle)
template <int K>
void pow_q14_K(const ifma::Fq8 *base, ifma::Fq8 *out) {
    using namespace ifma;
    bool started = false;
    ifma::Fq8 acc[K];
    for (int limb = 5; limb >= 0; --limb) {
        for (int bit = 63; bit >= 0; --bit) {
            if (started)
                for (int k = 0; k < K; ++k) sqr8(acc[k], acc[k]);
            if ((Q14[limb] >> bit) & 1) {
                if (started) {
                    for (int k = 0; k < K; ++k)
                        montmul8(acc[k], base[k], acc[k]);
                } else {
                    for (int k = 0; k < K; ++k) acc[k] = base[k];
                    started = true;
                }
            }
        }
    }
    for (int k = 0; k < K; ++k) out[k] = acc[k];
}

// Endomorphism G1-membership test for 8 lanes of affine points (M. Scott,
// "A note on group membership tests for G1, G2 and GT", ePrint 2021/1130;
// the same test blst ships):  P in G1  <=>  phi(P) == lambda*P with
// phi(x,y) = (beta*x, y) and lambda = -z^2 mod r (z the BLS parameter, and
// the beta/lambda pairing this library uses — see host/glv.py).  So check
// phi(P) + z^2*P == O via Q = |z|*(|z|*P):  beta*x*Qz^2 == Qx  and
// y*Qz^3 == -Qy.  ~126 doublings + 12 adds, vs ~252 dbl + 70 add for the
// [r]P ladder this replaces (the reference relies on arkworks'
// is_in_correct_subgroup_assuming_on_curve, whisk.rs:265-341 path).
template <int K>
void subgroup_endo_K(const ifma::Fq8 *bx, const ifma::Fq8 *by,
                     const __mmask8 *binf, __mmask8 *okm) {
    using namespace ifma;
    Fq8 one, zero;
    broadcast8(ONE_MONT52, one);
    set_zero8(zero);
    Jac8 q[K];
    for (int k = 0; k < K; ++k) {
        q[k].X = bx[k];
        q[k].Y = by[k];
        select8(binf[k], zero, one, q[k].Z);
    }
    const uint64_t Z_ABS = 0xd201000000010000ULL;  // |z|, top bit 63
    for (int pass = 0; pass < 2; ++pass) {  // q = |z| * (|z| * P)
        Jac8 src[K], acc[K];
        for (int k = 0; k < K; ++k) { src[k] = q[k]; acc[k] = q[k]; }
        for (int b = 62; b >= 0; --b) {    // shared ladder bits: K groups
            dbl_jacK<K>(acc);              // advance in lockstep
            if ((Z_ABS >> b) & 1) add_jacK<K>(acc, src);
        }
        for (int k = 0; k < K; ++k) q[k] = acc[k];
    }
    for (int k = 0; k < K; ++k) {
        Fq8 beta, zz, zzz, phix, lx, ly, ynegq;
        broadcast8(BETA_MONT52, beta);
        sqr8(q[k].Z, zz);
        montmul8(zz, q[k].Z, zzz);
        montmul8(beta, bx[k], phix);
        montmul8(phix, zz, lx);
        montmul8(by[k], zzz, ly);
        neg8(q[k].Y, ynegq);
        // q == O with P != O means ord(P) | z^2, coprime to r: not in G1.
        __mmask8 ok = (__mmask8)(eq8(lx, q[k].X) & eq8(ly, ynegq)
                                 & (__mmask8)~is_zero8(q[k].Z));
        okm[k] = (__mmask8)(binf[k] | ok);
    }
}

// Endomorphism membership test over n affine Montgomery-form points
// (live[i] = 0 lanes pass trivially), 2 x 8-lane groups in flight.
void subgroup_endo_batch(const Fq *bx, const Fq *by, const uint8_t *live,
                         uint64_t n, uint8_t *ok) {
    using namespace ifma;
    std::vector<u64> x52(((n + 7) / 8) * 64), y52(((n + 7) / 8) * 64);
    convert_to52_batch(bx, n, x52.data());
    convert_to52_batch(by, n, y52.data());
    uint64_t ngroups = (n + 7) / 8;
    auto load_group = [&](uint64_t g, Fq8 &X8, Fq8 &Y8, __mmask8 &binf) {
        const u64 *sx[8], *sy[8];
        binf = 0;
        for (int k = 0; k < 8; ++k) {
            uint64_t e = 8 * g + (uint64_t)k < n ? 8 * g + k : 8 * g;
            sx[k] = x52.data() + e * 8;
            sy[k] = y52.data() + e * 8;
            if (8 * g + k >= n || !live[e]) binf = (__mmask8)(binf | (1u << k));
        }
        load8(sx, X8);
        load8(sy, Y8);
    };
    auto store_group = [&](uint64_t g, __mmask8 okm) {
        for (int k = 0; k < 8 && 8 * g + (uint64_t)k < n; ++k)
            ok[8 * g + k] = (okm >> k) & 1;
    };
    static const int KDEPTH = []() {
        const char *e = std::getenv("CP_SUBGROUP_K");
        int v = e ? std::atoi(e) : 3;
        return (v >= 1 && v <= 4) ? v : 2;
    }();
    uint64_t g = 0;
    auto run = [&](auto kc, uint64_t g0) {
        constexpr int KK = decltype(kc)::value;
        Fq8 X8[KK], Y8[KK];
        __mmask8 binf[KK], okm[KK];
        for (int j = 0; j < KK; ++j) load_group(g0 + j, X8[j], Y8[j], binf[j]);
        subgroup_endo_K<KK>(X8, Y8, binf, okm);
        for (int j = 0; j < KK; ++j) store_group(g0 + j, okm[j]);
    };
    if (KDEPTH >= 4)
        for (; g + 4 <= ngroups; g += 4)
            run(std::integral_constant<int, 4>{}, g);
    if (KDEPTH >= 3)
        for (; g + 3 <= ngroups; g += 3)
            run(std::integral_constant<int, 3>{}, g);
    if (KDEPTH >= 2)
        for (; g + 2 <= ngroups; g += 2)
            run(std::integral_constant<int, 2>{}, g);
    for (; g < ngroups; ++g)
        run(std::integral_constant<int, 1>{}, g);
}

#endif  // CP_HAVE_IFMA

// Scalar (non-IFMA) twin of subgroup_endo8 for one affine point (z = 1 in
// Montgomery form); same math, 64-bit limb arithmetic.
bool subgroup_endo_scalar(const G1 &p) {
    if (g1_is_inf(p)) return true;
    static const uint8_t Z2_LE[32] = {  // z^2 = 0xac45a4010001a4020000000100000000
        0, 0, 0, 0, 1, 0, 0, 0,
        0x02, 0xa4, 0x01, 0x00, 0x01, 0xa4, 0x45, 0xac,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    G1 q;
    g1_mul(p, Z2_LE, q);
    if (g1_is_inf(q)) return false;
    Fq beta, zz, zzz, phix, lx, ly, ynegq;
    std::memcpy(beta.l, BETA_MONT, 48);
    fq_sqr(q.z, zz);
    fq_mul(zz, q.z, zzz);
    fq_mul(beta, p.x, phix);
    fq_mul(phix, zz, lx);
    fq_mul(p.y, zzz, ly);
    fq_neg(q.y, ynegq);
    return !std::memcmp(lx.l, q.x.l, 48) && !std::memcmp(ly.l, ynegq.l, 48);
}

// Runs body(lo, hi) over n points cut into contiguous pieces, on the calling
// thread and on std::threads of its own, all joined before returning;
// returns the number of threads the call ran on.  Each thread claims the
// next piece from a shared counter as it finishes one, so a thread whose
// core is busy with other work takes fewer pieces, not the whole call's
// time.  threads = 0 takes the cores of the process's affinity mask (which
// follows taskset, cgroup cpusets and a parent's pinning), at most one per
// 64 points, so small calls stay on the calling thread.  A piece is about
// an eighth of a thread's share, a multiple of SPLIT_ALIGN points (8 IFMA
// lanes x 3 groups in flight), so only the last piece runs part-full lane
// groups; no more threads start than there are pieces.  Threads are made
// per call: a pool outliving the call would not survive a fork.
constexpr uint64_t SPLIT_ALIGN = 24;
constexpr uint64_t SPLIT_MIN_POINTS = 64;
constexpr uint64_t SPLIT_PIECES = 8;   // pieces a thread

template <class Body>
uint32_t split_points(uint64_t n, uint64_t threads, const Body &body) {
    uint64_t t = threads;
    if (t == 0) {
        t = (n + SPLIT_MIN_POINTS - 1) / SPLIT_MIN_POINTS;
        if (t > 1) {   // small calls skip the system call
            cpu_set_t set;
            CPU_ZERO(&set);
            const uint64_t cores =
                sched_getaffinity(0, sizeof set, &set) == 0 ? CPU_COUNT(&set)
                                                            : 1;
            t = std::min(t, cores);
        }
    }
    t = std::max<uint64_t>(t, 1);
    const uint64_t share = (n + t * SPLIT_PIECES - 1) / (t * SPLIT_PIECES);
    const uint64_t piece =
        std::max<uint64_t>((share + SPLIT_ALIGN - 1) / SPLIT_ALIGN, 1) *
        SPLIT_ALIGN;
    t = std::max<uint64_t>(std::min(t, (n + piece - 1) / piece), 1);
    std::atomic<uint64_t> next{0};
    auto run = [&] {
        for (uint64_t lo; (lo = next.fetch_add(piece)) < n;)
            body(lo, std::min(n, lo + piece));
    };
    std::vector<std::thread> workers;
    for (uint64_t i = 1; i < t; ++i) {
        try {
            workers.emplace_back(run);
        } catch (const std::system_error &) {   // no thread: the rest share
            break;
        }
    }
    run();
    for (auto &w : workers) w.join();
    return (uint32_t)(1 + workers.size());
}

// cp_g1_decompress_validate's work over one piece of points.
void decompress_validate_range(const uint8_t *comp, uint64_t n, uint8_t *out,
                               uint8_t *flags, bool check_subgroup,
                               bool use_ifma) {
    // parse + x^3 + 4 (Montgomery domain)
    std::vector<Fq> xs(n), ts(n);          // x, x^3+4
    std::vector<uint8_t> inf(n, 0), sort_flag(n, 0);
    Fq four;
    std::memset(four.l, 0, 48);
    four.l[0] = 4;
    to_mont(four);
    for (uint64_t i = 0; i < n; ++i) {
        const uint8_t *c = comp + 48 * i;
        flags[i] = 0;
        std::memset(out + 144 * i, 0, 144);
        if (!(c[0] & 0x80)) { flags[i] = 1; continue; }   // must be compressed
        if (c[0] & 0x40) {                                 // infinity
            uint8_t acc = (uint8_t)(c[0] & 0x3f);
            for (int b = 1; b < 48; ++b) acc |= c[b];
            if (acc) flags[i] = 1;
            inf[i] = 1;                                    // z = 0 already
            continue;
        }
        sort_flag[i] = (c[0] >> 5) & 1;
        uint8_t be[48];
        std::memcpy(be, c, 48);
        be[0] &= 0x1f;
        Fq x;
        for (int b = 0; b < 48; ++b)
            ((uint8_t *)x.l)[b] = be[47 - b];              // BE -> LE limbs
        if (fq_geq_p(x)) { flags[i] = 1; continue; }
        to_mont(x);
        xs[i] = x;
        Fq x2, x3;
        fq_sqr(x, x2);
        fq_mul(x2, x, x3);
        fq_add(x3, four, ts[i]);
    }
    std::vector<Fq> ys(n);
    std::vector<uint8_t> on_curve(n, 0);
#if CP_HAVE_IFMA
    if (use_ifma) {
        std::vector<u64> t52(((n + 7) / 8) * 64), y52(((n + 7) / 8) * 64);
        convert_to52_batch(ts.data(), n, t52.data());
        uint64_t ngroups = (n + 7) / 8;
        auto load_t = [&](uint64_t g, ifma::Fq8 &t8) {
            const u64 *src[8];
            for (int k = 0; k < 8; ++k) {
                uint64_t e = 8 * g + (uint64_t)k < n ? 8 * g + k : 8 * g;
                src[k] = t52.data() + e * 8;
            }
            ifma::load8(src, t8);
        };
        auto store_y = [&](uint64_t g, const ifma::Fq8 &y8) {
            u64 *dst[8];
            for (int k = 0; k < 8; ++k) {
                uint64_t e = 8 * g + (uint64_t)k < n ? 8 * g + k : 8 * g;
                dst[k] = y52.data() + e * 8;
            }
            unsigned lanes = 8 * g + 8 <= n ? 0xffu
                                            : ((1u << (n - 8 * g)) - 1u);
            ifma::store8(y8, dst, lanes);
        };
        // groups in flight (register budget: Fq8 = 8 ZMMs): one group's
        // sqr/mul chain is latency-bound, interleaving fills the pipeline
        static const int KSQ = []() {
            const char *e = std::getenv("CP_SQRT_K");
            int v = e ? std::atoi(e) : 3;
            return (v >= 1 && v <= 4) ? v : 2;
        }();
        uint64_t g = 0;
        auto run_pow = [&](auto kc, uint64_t g0) {
            constexpr int KK = decltype(kc)::value;
            ifma::Fq8 t8[KK], y8[KK];
            for (int j = 0; j < KK; ++j) load_t(g0 + j, t8[j]);
            pow_q14_K<KK>(t8, y8);
            for (int j = 0; j < KK; ++j) store_y(g0 + j, y8[j]);
        };
        if (KSQ >= 4)
            for (; g + 4 <= ngroups; g += 4)
                run_pow(std::integral_constant<int, 4>{}, g);
        if (KSQ >= 3)
            for (; g + 3 <= ngroups; g += 3)
                run_pow(std::integral_constant<int, 3>{}, g);
        if (KSQ >= 2)
            for (; g + 2 <= ngroups; g += 2)
                run_pow(std::integral_constant<int, 2>{}, g);
        for (; g < ngroups; ++g)
            run_pow(std::integral_constant<int, 1>{}, g);
        convert_from52_batch(y52.data(), n, ys.data());
    } else
#endif
    {
        for (uint64_t i = 0; i < n; ++i) {
            if (flags[i] || inf[i]) continue;
            // scalar pow by (q+1)/4
            Fq acc;
            bool started = false;
            for (int limb = 5; limb >= 0; --limb)
                for (int bit = 63; bit >= 0; --bit) {
                    if (started) fq_sqr(acc, acc);
                    if ((Q14[limb] >> bit) & 1) {
                        if (started) fq_mul(acc, ts[i], acc);
                        else { acc = ts[i]; started = true; }
                    }
                }
            ys[i] = acc;
        }
    }
    // curve check + root selection (larger canonical root iff sort flag)
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) {
        if (flags[i] || inf[i]) continue;
        Fq y2;
        fq_sqr(ys[i], y2);
        if (std::memcmp(y2.l, ts[i].l, 48)) { flags[i] = 2; continue; }
        // canonical forms of y and p - y
        Fq y_c = ys[i];
        from_mont(y_c);
        Fq yn;
        fq_neg(ys[i], yn);
        Fq yn_c = yn;
        from_mont(yn_c);
        bool y_is_larger = false;
        for (int l = 5; l >= 0; --l) {
            if (y_c.l[l] != yn_c.l[l]) { y_is_larger = y_c.l[l] > yn_c.l[l]; break; }
        }
        Fq y_sel = (y_is_larger == (bool)sort_flag[i]) ? ys[i] : yn;
        pts[i].x = xs[i];
        pts[i].y = y_sel;
        std::memcpy(pts[i].z.l, ONE_MONT, 48);
        on_curve[i] = 1;
    }
    // subgroup checks
    if (!check_subgroup) {
        for (uint64_t i = 0; i < n; ++i)
            if (on_curve[i] && flags[i] == 0) store_g1(pts[i], out + 144 * i);
        return;
    }
#if CP_HAVE_IFMA
    if (use_ifma) {
        std::vector<Fq> bx(n), by(n);
        for (uint64_t i = 0; i < n; ++i) {
            if (on_curve[i]) { bx[i] = pts[i].x; by[i] = pts[i].y; }
            else { std::memset(bx[i].l, 0, 48); std::memset(by[i].l, 0, 48); }
        }
        std::vector<uint8_t> ok(n);
        subgroup_endo_batch(bx.data(), by.data(), on_curve.data(), n,
                            ok.data());
        for (uint64_t i = 0; i < n; ++i)
            if (on_curve[i] && !ok[i]) flags[i] = 3;
    } else
#endif
    {
        for (uint64_t i = 0; i < n; ++i)
            if (on_curve[i] && !subgroup_endo_scalar(pts[i])) flags[i] = 3;
    }
    for (uint64_t i = 0; i < n; ++i)
        if (on_curve[i] && flags[i] == 0) store_g1(pts[i], out + 144 * i);
}

// cp_subgroup_check's work over one piece of points.
void subgroup_check_range(const uint8_t *points, uint64_t n, uint8_t *flags,
                          bool use_ifma) {
    std::vector<G1> pts(n);
    for (uint64_t i = 0; i < n; ++i) load_g1(points + 144 * i, pts[i]);
    batch_normalize(pts.data(), n);
#if CP_HAVE_IFMA
    if (use_ifma) {
        std::vector<Fq> bx(n), by(n);
        std::vector<uint8_t> live(n);
        for (uint64_t i = 0; i < n; ++i) {
            live[i] = !g1_is_inf(pts[i]);
            if (!live[i]) { std::memset(bx[i].l, 0, 48); std::memset(by[i].l, 0, 48); }
            else { bx[i] = pts[i].x; by[i] = pts[i].y; }
        }
        std::vector<uint8_t> ok(n);
        subgroup_endo_batch(bx.data(), by.data(), live.data(), n, ok.data());
        for (uint64_t i = 0; i < n; ++i) flags[i] = ok[i] ? 0 : 1;
        return;
    }
#endif
    for (uint64_t i = 0; i < n; ++i)
        flags[i] = subgroup_endo_scalar(pts[i]) ? 0 : 1;
}

bool ifma_enabled() {
#if CP_HAVE_IFMA
    return !std::getenv("CP_NO_IFMA");
#else
    return false;
#endif
}

}  // namespace

extern "C" {

// comp: n x 48-byte compressed points. out: n x 144-byte Jacobian canonical.
// flags[i]: 0 = valid, 1 = malformed encoding, 2 = x not on curve,
// 3 = not in the prime-order subgroup. Infinity decodes valid with z = 0.
// check_subgroup = 0 skips the (deferrable) subgroup test — callers batch it
// separately via cp_subgroup_check so 8-wide lanes stay full.  The points
// are split across threads (`split_points`); every piece runs the same
// per-point code, so flags and out are the same at any thread count.
// threads = 0, which every caller in the package passes, takes the count
// from the process's cores; a count > 0 fixes it, for the tests.  Returns
// the number of threads used.
uint32_t cp_g1_decompress_validate(const uint8_t *comp, uint64_t n,
                                   uint8_t *out, uint8_t *flags,
                                   uint64_t check_subgroup, uint64_t threads) {
    const bool use_ifma = ifma_enabled();
    return split_points(n, threads, [&](uint64_t lo, uint64_t hi) {
        decompress_validate_range(comp + 48 * lo, hi - lo, out + 144 * lo,
                                  flags + lo, check_subgroup != 0, use_ifma);
    });
}

// points: n x 144-byte Jacobian canonical. flags[i]: 0 = in the prime-order
// subgroup (infinity counts as in), 1 = not.  Split across threads as
// cp_g1_decompress_validate; returns the number of threads used.
uint32_t cp_subgroup_check(const uint8_t *points, uint64_t n, uint8_t *flags,
                           uint64_t threads) {
    const bool use_ifma = ifma_enabled();
    return split_points(n, threads, [&](uint64_t lo, uint64_t hi) {
        subgroup_check_range(points + 144 * lo, hi - lo, flags + lo, use_ifma);
    });
}

}  // extern "C"

// ---- GLV scalar decomposition (batch, host-side) ----
// Babai rounding k = k1 + k2*lambda with the short lattice basis; constants
// (basis vectors, r, Barrett mu) are injected once from the Python module
// that derives and validates them (host/glv.py). Exact rounding via Barrett
// quotient + correction loop, so the |k1|,|k2| < 2^129 bound of the Python
// path is reproduced bit-for-bit.

namespace {

struct GlvCtx {
    u64 a1[2], b1[2], a2[2], b2[2];  // basis magnitudes (< 2^128)
    int sa1, sb1, sa2, sb2;          // basis signs (+1 / -1)
    u64 r[4];                        // scalar field order
    u64 mu[7];                       // floor(2^640 / (2r)), 385 bits
    u64 d[5];                        // 2r
    bool ready = false;
};
static GlvCtx GLV;

// out[no] = a[na] * b[nb] (truncated to no limbs; caller sizes correctly)
inline void bn_mul(const u64 *a, int na, const u64 *b, int nb, u64 *out,
                   int no) {
    for (int i = 0; i < no; ++i) out[i] = 0;
    for (int i = 0; i < na; ++i) {
        u128 carry = 0;
        for (int j = 0; j < nb && i + j < no; ++j) {
            u128 cur = (u128)out[i + j] + (u128)a[i] * b[j] + (u64)carry;
            out[i + j] = (u64)cur;
            carry = cur >> 64;
        }
        if (i + nb < no) {
            int k = i + nb;
            while (carry && k < no) {
                u128 cur = (u128)out[k] + (u64)carry;
                out[k] = (u64)cur;
                carry = cur >> 64;
                ++k;
            }
        }
    }
}

// a[n] -= b[n]; returns borrow
inline u64 bn_sub(u64 *a, const u64 *b, int n) {
    u128 borrow = 0;
    for (int i = 0; i < n; ++i) {
        u128 cur = (u128)a[i] - b[i] - (u64)borrow;
        a[i] = (u64)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
    return (u64)borrow;
}

inline int bn_cmp(const u64 *a, const u64 *b, int n) {
    for (int i = n - 1; i >= 0; --i) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return -1;
    }
    return 0;
}

// q = floor(N / D) with N < 2^387 (7 limbs), D = GLV.d (5 limbs);
// exact via Barrett estimate + correction. q fits 3 limbs.
inline void glv_div(const u64 N[7], u64 q[3]) {
    // q_hat = ((N >> 256) * mu) >> 384
    u64 hi[3] = {N[4], N[5], N[6]};
    u64 prod[10];
    bn_mul(hi, 3, GLV.mu, 7, prod, 10);
    u64 qh[3] = {prod[6], prod[7], prod[8]};
    // rem = N - q_hat * D (8 limbs to be safe)
    u64 qd[8];
    bn_mul(qh, 3, GLV.d, 5, qd, 8);
    u64 rem[8] = {N[0], N[1], N[2], N[3], N[4], N[5], N[6], 0};
    bn_sub(rem, qd, 8);
    // correction: while rem >= D: rem -= D, q += 1
    u64 dext[8] = {GLV.d[0], GLV.d[1], GLV.d[2], GLV.d[3], GLV.d[4], 0, 0, 0};
    for (;;) {
        if (bn_cmp(rem, dext, 8) < 0) break;
        bn_sub(rem, dext, 8);
        u128 c = (u128)qh[0] + 1;
        qh[0] = (u64)c;
        if (c >> 64) { if (++qh[1] == 0) ++qh[2]; }
    }
    q[0] = qh[0]; q[1] = qh[1]; q[2] = qh[2];
}

// signed 5-limb accumulator helpers (two's complement)
inline void s320_sub(u64 *acc, const u64 *v, int n) {  // acc -= v (v: n limbs)
    u128 borrow = 0;
    for (int i = 0; i < 5; ++i) {
        u64 vi = i < n ? v[i] : 0;
        u128 cur = (u128)acc[i] - vi - (u64)borrow;
        acc[i] = (u64)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
}

inline void s320_add(u64 *acc, const u64 *v, int n) {
    u128 carry = 0;
    for (int i = 0; i < 5; ++i) {
        u64 vi = i < n ? v[i] : 0;
        u128 cur = (u128)acc[i] + vi + (u64)carry;
        acc[i] = (u64)cur;
        carry = cur >> 64;
    }
}

}  // namespace

extern "C" {

void cp_glv_init(const uint8_t *a1, int32_t sa1, const uint8_t *b1,
                 int32_t sb1, const uint8_t *a2, int32_t sa2,
                 const uint8_t *b2, int32_t sb2, const uint8_t *r32,
                 const uint8_t *mu56, const uint8_t *d40) {
    std::memcpy(GLV.a1, a1, 16);
    std::memcpy(GLV.b1, b1, 16);
    std::memcpy(GLV.a2, a2, 16);
    std::memcpy(GLV.b2, b2, 16);
    GLV.sa1 = sa1; GLV.sb1 = sb1; GLV.sa2 = sa2; GLV.sb2 = sb2;
    std::memcpy(GLV.r, r32, 32);
    std::memcpy(GLV.mu, mu56, 56);
    std::memcpy(GLV.d, d40, 40);
    GLV.ready = true;
}

// ks: n 32-byte scalars (< r). Outputs 16-byte magnitudes + sign flags.
// Returns 0 on success, -1 if uninitialised, 1 if any half >= 2^128.
int32_t cp_glv_decompose(const uint8_t *ks, uint64_t n, uint8_t *k1s,
                         uint8_t *negs1, uint8_t *k2s, uint8_t *negs2) {
    if (!GLV.ready) return -1;
    for (uint64_t i = 0; i < n; ++i) {
        u64 k[4];
        std::memcpy(k, ks + 32 * i, 32);
        // c1 = floor((2*b2*k + r) / (2r)), c2 = floor((2*b1*k + r) / (2r))
        // (the sign of the b-coefficient folds into the +- below)
        u64 c[2][3];
        const u64 *bs[2] = {GLV.b2, GLV.b1};
        for (int t = 0; t < 2; ++t) {
            u64 num[7];
            bn_mul(bs[t], 2, k, 4, num, 7);
            // *2
            u64 top = 0;
            for (int j = 6; j >= 1; --j)
                num[j] = (num[j] << 1) | (num[j - 1] >> 63);
            num[0] <<= 1;
            (void)top;
            // + r
            u128 carry = 0;
            for (int j = 0; j < 7; ++j) {
                u64 rj = j < 4 ? GLV.r[j] : 0;
                u128 cur = (u128)num[j] + rj + (u64)carry;
                num[j] = (u64)cur;
                carry = cur >> 64;
            }
            glv_div(num, c[t]);
        }
        // Babai: c1 = round(b2*k/det), c2 = round(-b1*k/det) with det = r > 0
        // (python: c1 = (b2*k*2 + det) // (2*det) with SIGNED b2).
        // Here magnitudes were used; re-apply the signs:
        //   signed c1 = sb2 >= 0 ? +c[0] : -(c[0] adjusted)  — handled by
        // tracking each product's sign when accumulating k1/k2 below. For
        // negative numerators python's floor-division differs from the
        // magnitude version by at most 1; the correction loop below absorbs
        // it by re-centering k1/k2 if a half overflows 2^128.
        // k1 = k - c1*a1 - c2*a2 ; k2 = -(c1*b1 + c2*b2)
        // signed c1 = sgn(b2)*c[0], signed c2 = -sgn(b1)*c[1]
        u64 acc1[5] = {k[0], k[1], k[2], k[3], 0};
        u64 acc2[5] = {0, 0, 0, 0, 0};
        int sc1 = GLV.sb2 >= 0 ? 1 : -1;
        int sc2 = GLV.sb1 >= 0 ? -1 : 1;
        u64 prod[5];
        // acc1 -= c1*a1 (signed)
        bn_mul(c[0], 3, GLV.a1, 2, prod, 5);
        if (sc1 * GLV.sa1 > 0) s320_sub(acc1, prod, 5);
        else s320_add(acc1, prod, 5);
        // acc1 -= c2*a2
        bn_mul(c[1], 3, GLV.a2, 2, prod, 5);
        if (sc2 * GLV.sa2 > 0) s320_sub(acc1, prod, 5);
        else s320_add(acc1, prod, 5);
        // acc2 = -(c1*b1 + c2*b2)
        bn_mul(c[0], 3, GLV.b1, 2, prod, 5);
        if (sc1 * GLV.sb1 > 0) s320_sub(acc2, prod, 5);
        else s320_add(acc2, prod, 5);
        bn_mul(c[1], 3, GLV.b2, 2, prod, 5);
        if (sc2 * GLV.sb2 > 0) s320_sub(acc2, prod, 5);
        else s320_add(acc2, prod, 5);
        // extract sign/magnitude
        u64 *accs[2] = {acc1, acc2};
        uint8_t *mags[2] = {k1s + 16 * i, k2s + 16 * i};
        uint8_t *sgn[2] = {negs1 + i, negs2 + i};
        for (int t = 0; t < 2; ++t) {
            u64 *a = accs[t];
            bool neg = (a[4] >> 63) != 0;
            u64 mag[5];
            if (neg) {
                u128 borrow = 0;
                for (int j = 0; j < 5; ++j) {
                    u128 cur = (u128)0 - a[j] - (u64)borrow;
                    mag[j] = (u64)cur;
                    borrow = a[j] || borrow ? 1 : 0;
                }
            } else {
                std::memcpy(mag, a, 40);
            }
            if (mag[2] | mag[3] | mag[4]) return 1;  // half >= 2^128
            std::memcpy(mags[t], mag, 16);
            *sgn[t] = neg ? 1 : 0;
        }
    }
    return 0;
}

}  // extern "C"

// ---- ChaCha12 block function (rand 0.8 StdRng hot path) ----
// Semantics mirror host/rng.py::_chacha12_four_blocks exactly (djb variant,
// 64-bit block counter in words 12-13, words 14-15 zero).

extern "C" {

void cp_chacha12_four_blocks(const uint32_t key[8], uint64_t counter,
                             uint32_t out[64]) {
    for (int blk = 0; blk < 4; ++blk) {
        uint64_t ctr = counter + (uint64_t)blk;
        uint32_t st[16] = {
            0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
            key[0], key[1], key[2], key[3],
            key[4], key[5], key[6], key[7],
            (uint32_t)ctr, (uint32_t)(ctr >> 32), 0, 0,
        };
        uint32_t x[16];
        std::memcpy(x, st, sizeof(x));
#define CP_ROTL(v, r) (((v) << (r)) | ((v) >> (32 - (r))))
#define CP_QR(a, b, c, d)                                   \
        x[a] += x[b]; x[d] ^= x[a]; x[d] = CP_ROTL(x[d], 16); \
        x[c] += x[d]; x[b] ^= x[c]; x[b] = CP_ROTL(x[b], 12); \
        x[a] += x[b]; x[d] ^= x[a]; x[d] = CP_ROTL(x[d], 8);  \
        x[c] += x[d]; x[b] ^= x[c]; x[b] = CP_ROTL(x[b], 7)
        for (int r = 0; r < 6; ++r) {
            CP_QR(0, 4, 8, 12);
            CP_QR(1, 5, 9, 13);
            CP_QR(2, 6, 10, 14);
            CP_QR(3, 7, 11, 15);
            CP_QR(0, 5, 10, 15);
            CP_QR(1, 6, 11, 12);
            CP_QR(2, 7, 8, 13);
            CP_QR(3, 4, 9, 14);
        }
#undef CP_QR
#undef CP_ROTL
        for (int i = 0; i < 16; ++i) out[blk * 16 + i] = x[i] + st[i];
    }
}

}  // extern "C"

// ---- STROBE-128 state machine (merlin transcript hot path) ----
// State blob layout (208 bytes): state[200] | pos | pos_begin | cur_flags | pad
// Semantics mirror merlin's strobe.rs exactly (see host/strobe.py, the
// pure-Python golden model).

namespace {

const int STROBE_R = 166;

struct StrobeState {
    uint8_t st[200];
    uint8_t pos;
    uint8_t pos_begin;
    uint8_t cur_flags;
    uint8_t _pad[5];
};

void strobe_run_f(StrobeState &s) {
    s.st[s.pos] ^= s.pos_begin;
    s.st[s.pos + 1] ^= 0x04;
    s.st[STROBE_R + 1] ^= 0x80;
    cp_keccak_f1600(s.st);
    s.pos = 0;
    s.pos_begin = 0;
}

void strobe_absorb(StrobeState &s, const uint8_t *data, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        s.st[s.pos] ^= data[i];
        if (++s.pos == STROBE_R) strobe_run_f(s);
    }
}

void strobe_squeeze(StrobeState &s, uint8_t *out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        out[i] = s.st[s.pos];
        s.st[s.pos] = 0;
        if (++s.pos == STROBE_R) strobe_run_f(s);
    }
}

void strobe_begin_op(StrobeState &s, uint8_t flags, int more) {
    if (more) return;
    uint8_t old_begin = s.pos_begin;
    s.pos_begin = s.pos + 1;
    s.cur_flags = flags;
    uint8_t hdr[2] = {old_begin, flags};
    strobe_absorb(s, hdr, 2);
    bool force_f = flags & (0x04 | 0x20);  // C | K
    if (force_f && s.pos != 0) strobe_run_f(s);
}

}  // namespace

extern "C" {

void cp_strobe_init(uint8_t *blob, const uint8_t *label, uint64_t label_len) {
    StrobeState &s = *reinterpret_cast<StrobeState *>(blob);
    std::memset(&s, 0, sizeof(s));
    const uint8_t init[6] = {1, STROBE_R + 2, 1, 0, 1, 96};
    std::memcpy(s.st, init, 6);
    std::memcpy(s.st + 6, "STROBEv1.0.2", 12);
    cp_keccak_f1600(s.st);
    // meta_ad(label, false)
    strobe_begin_op(s, 0x10 | 0x02, 0);
    strobe_absorb(s, label, label_len);
}

void cp_strobe_meta_ad(uint8_t *blob, const uint8_t *data, uint64_t n,
                       int32_t more) {
    StrobeState &s = *reinterpret_cast<StrobeState *>(blob);
    strobe_begin_op(s, 0x10 | 0x02, more);
    strobe_absorb(s, data, n);
}

void cp_strobe_ad(uint8_t *blob, const uint8_t *data, uint64_t n,
                  int32_t more) {
    StrobeState &s = *reinterpret_cast<StrobeState *>(blob);
    strobe_begin_op(s, 0x02, more);
    strobe_absorb(s, data, n);
}

void cp_strobe_prf(uint8_t *blob, uint8_t *out, uint64_t n, int32_t more) {
    StrobeState &s = *reinterpret_cast<StrobeState *>(blob);
    strobe_begin_op(s, 0x01 | 0x02 | 0x04, more);
    strobe_squeeze(s, out, n);
}

// merlin append_message(label, msg) for `count` equal-size messages in one
// call (point-vector transcript appends are 3 ctypes calls per point
// otherwise). Semantics per message: meta_ad(label, false);
// meta_ad(len_le32, true); ad(msg, false) — transcript.rs:29-33.
void cp_strobe_append_many(uint8_t *blob, const uint8_t *label,
                           uint64_t label_len, const uint8_t *msgs,
                           uint64_t msg_size, uint64_t count) {
    StrobeState &s = *reinterpret_cast<StrobeState *>(blob);
    uint8_t len_le[4] = {
        (uint8_t)msg_size, (uint8_t)(msg_size >> 8),
        (uint8_t)(msg_size >> 16), (uint8_t)(msg_size >> 24)};
    for (uint64_t i = 0; i < count; ++i) {
        strobe_begin_op(s, 0x10 | 0x02, /*more=*/0);   // META_AD (M|A)
        strobe_absorb(s, label, label_len);
        strobe_begin_op(s, 0x10 | 0x02, /*more=*/1);
        strobe_absorb(s, len_le, 4);
        strobe_begin_op(s, 0x02, /*more=*/0);          // AD (A)
        strobe_absorb(s, msgs + i * msg_size, msg_size);
    }
}

// The full merlin challenge loop (transcript.rs:41-54) for `count` Fr
// challenges in ONE call: challenge_bytes(label, 64) -> first 32 bytes LE
// masked to 255 bits -> reject zero / >= r and retry -> re-append the
// accepted 32-byte value under the same label. out: count x 32 bytes LE.
void cp_transcript_challenges(uint8_t *blob, const uint8_t *label,
                              uint64_t label_len, uint64_t count,
                              uint8_t *out) {
    StrobeState &s = *reinterpret_cast<StrobeState *>(blob);
    const uint8_t len64[4] = {64, 0, 0, 0};
    const uint8_t len32[4] = {32, 0, 0, 0};
    for (uint64_t i = 0; i < count; ++i) {
        for (;;) {
            strobe_begin_op(s, 0x10 | 0x02, 0);        // meta_ad(label)
            strobe_absorb(s, label, label_len);
            strobe_begin_op(s, 0x10 | 0x02, 1);        // meta_ad(len, more)
            strobe_absorb(s, len64, 4);
            uint8_t buf[64];
            strobe_begin_op(s, 0x01 | 0x02 | 0x04, 0); // prf
            strobe_squeeze(s, buf, 64);
            buf[31] &= 0x7f;                           // 255-bit mask
            u64 v[4];
            std::memcpy(v, buf, 32);
            bool zero = !(v[0] | v[1] | v[2] | v[3]);
            bool ge = true;                            // equal counts as >=
            for (int l = 3; l >= 0; --l) {
                if (v[l] > R_ORDER[l]) break;
                if (v[l] < R_ORDER[l]) { ge = false; break; }
            }
            if (zero || ge) continue;
            strobe_begin_op(s, 0x10 | 0x02, 0);        // append_message
            strobe_absorb(s, label, label_len);
            strobe_begin_op(s, 0x10 | 0x02, 1);
            strobe_absorb(s, len32, 4);
            strobe_begin_op(s, 0x02, 0);
            strobe_absorb(s, buf, 32);
            std::memcpy(out + 32 * i, buf, 32);
            break;
        }
    }
}

}  // extern "C"

// ---- native prover round loops ----
// The IPA and SameMsm provers' folding recursions (inner_product_argument.rs:
// 150-186, same_multiscalar_argument.rs:99-136) run log n rounds of
// {shared-bucket MSMs, transcript absorb + challenge, scalar fold, point
// fold}. Doing each round from Python costs ~10 marshalling boundaries per
// round; these loops keep the whole recursion native, sharing the strobe
// state blob with the Python Transcript. The H*<c,d> terms of the IPA's
// L_C/R_C fold into the round's shared-bucket MSM as extra (H, ip) entries.

namespace {

inline void fr4_addmod(const Fr4 &a, const Fr4 &b, Fr4 &r) {
    unsigned __int128 carry = 0;
    u64 t[4];
    for (int j = 0; j < 4; ++j) {
        unsigned __int128 cur = (unsigned __int128)a.l[j] + b.l[j] + (u64)carry;
        t[j] = (u64)cur;
        carry = cur >> 64;
    }
    bool ge = carry != 0;
    if (!ge) {
        ge = true;
        for (int j = 3; j >= 0; --j) {
            if (t[j] != R_ORDER[j]) { ge = t[j] > R_ORDER[j]; break; }
        }
    }
    if (ge) {
        unsigned __int128 borrow = 0;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 cur = (unsigned __int128)t[j] - R_ORDER[j]
                                    - (u64)borrow;
            r.l[j] = (u64)cur;
            borrow = (cur >> 64) ? 1 : 0;
        }
    } else {
        for (int j = 0; j < 4; ++j) r.l[j] = t[j];
    }
}

// r = a^(r_order - 2): ~255 squarings (the protocol runs one per fold round;
// latency is irrelevant next to the round's MSMs)
inline void fr4_inv_mont(const Fr4 &a, Fr4 &r) {
    u64 e[4];
    std::memcpy(e, R_ORDER, 32);
    e[0] -= 2;  // r is odd, no borrow
    Fr4 acc;
    bool started = false;
    for (int limb = 3; limb >= 0; --limb) {
        for (int bit = 63; bit >= 0; --bit) {
            if (started) fr4_mont_mul(acc, acc, acc);
            if ((e[limb] >> bit) & 1) {
                if (started) fr4_mont_mul(acc, a, acc);
                else { acc = a; started = true; }
            }
        }
    }
    r = acc;
}

// ZCash compressed encoding from a NORMALIZED canonical 144-byte block
// (z in {0,1}; cp_batch_normalize output). Matches host/serde.py g1_to_bytes.
inline void g1_compress_canonical(const uint8_t in[144], uint8_t out[48]) {
    bool inf = true;
    for (int i = 96; i < 144; ++i)
        if (in[i]) { inf = false; break; }
    if (inf) {
        std::memset(out, 0, 48);
        out[0] = 0x80 | 0x40;
        return;
    }
    for (int i = 0; i < 48; ++i) out[i] = in[47 - i];  // big-endian x
    uint8_t flags = 0x80;
    // sort flag: y > q - y  <=>  2y > q (y != 0 on this curve)
    u64 y[6];
    std::memcpy(y, in + 48, 48);
    u64 two_y[6];
    u64 top = y[5] >> 63;
    for (int j = 5; j >= 1; --j) two_y[j] = (y[j] << 1) | (y[j - 1] >> 63);
    two_y[0] = y[0] << 1;
    bool gt = top != 0;
    if (!gt) {
        for (int j = 5; j >= 0; --j) {
            if (two_y[j] != P[j]) { gt = two_y[j] > P[j]; break; }
        }
    }
    if (gt) flags |= 0x20;
    out[0] |= flags;
}

constexpr int kMaxLg = 32;

}  // namespace

extern "C" {

// SameMsm prover rounds (same_multiscalar_argument.rs:99-136). State and
// transcript evolve in place; returns 0 on success (nonzero -> caller falls
// back to the Python loop). pts_gtu: G||T||U as 3n canonical 144B blocks.
// xs: n canonical 32B LE Fr (already alpha-folded). out_lr: 6*lg_n blocks
// round-major [L_A,L_T,L_U,R_A,R_T,R_U]; x_final: 32B LE.
int32_t cp_same_msm_prove_loop(uint8_t *blob, const uint8_t *pts_gtu,
                               uint64_t n, const uint8_t *xs,
                               const uint8_t *beta48, uint8_t *out_lr,
                               uint8_t *x_final) {
    if (!n || (n & (n - 1))) return 1;
    std::vector<uint8_t> G(pts_gtu, pts_gtu + 144 * n);
    std::vector<uint8_t> T(pts_gtu + 144 * n, pts_gtu + 288 * n);
    std::vector<uint8_t> U(pts_gtu + 288 * n, pts_gtu + 432 * n);
    std::vector<Fr4> x(n);
    for (uint64_t i = 0; i < n; ++i) fr4_load(xs + 32 * i, x[i]);

    std::vector<uint8_t> xc(32 * n), k1(16 * n), k2(16 * n), n1(n), n2(n);
    std::vector<uint8_t> mpts(432 * n), mk1(48 * n), mk2(48 * n), mn1(3 * n),
        mn2(3 * n), outs(6 * 144), comp(6 * 48);
    std::vector<uint32_t> mid(3 * n);
    std::vector<uint8_t> foldL(216 * n), foldR(216 * n), foldO(216 * n);

    size_t len = n;
    int round = 0;
    while (len > 1) {
        size_t half = len / 2;
        for (size_t i = 0; i < len; ++i)
            fr4_store(x[i], xc.data() + 32 * i, false);
        if (cp_glv_decompose(xc.data(), len, k1.data(), n1.data(), k2.data(),
                             n2.data()) != 0)
            return 2;
        // groups: (G_R,x_L),(T_R,x_L),(U_R,x_L),(G_L,x_R),(T_L,x_R),(U_L,x_R)
        const uint8_t *gsrc[6] = {G.data() + 144 * half, T.data() + 144 * half,
                                  U.data() + 144 * half, G.data(), T.data(),
                                  U.data()};
        for (int g = 0; g < 6; ++g) {
            std::memcpy(mpts.data() + 144 * half * g, gsrc[g], 144 * half);
            size_t soff = (g < 3) ? 0 : half;  // x_L for 0-2, x_R for 3-5
            std::memcpy(mk1.data() + 16 * half * g, k1.data() + 16 * soff,
                        16 * half);
            std::memcpy(mk2.data() + 16 * half * g, k2.data() + 16 * soff,
                        16 * half);
            std::memcpy(mn1.data() + half * g, n1.data() + soff, half);
            std::memcpy(mn2.data() + half * g, n2.data() + soff, half);
            for (size_t i = 0; i < half; ++i) mid[half * g + i] = (uint32_t)g;
        }
        cp_msm_glv_many(mpts.data(), 6 * half, mk1.data(), mn1.data(),
                        mk2.data(), mn2.data(), beta48, mid.data(), 6,
                        outs.data());
        cp_batch_normalize(outs.data(), 6);
        std::memcpy(out_lr + 6 * 144 * (size_t)round, outs.data(), 6 * 144);
        for (int g = 0; g < 6; ++g)
            g1_compress_canonical(outs.data() + 144 * g, comp.data() + 48 * g);
        cp_strobe_append_many(blob, (const uint8_t *)"same_msm_loop", 13,
                              comp.data(), 48, 6);
        uint8_t gb[32];
        cp_transcript_challenges(blob, (const uint8_t *)"same_msm_gamma", 14,
                                 1, gb);
        Fr4 gamma, gamma_inv;
        fr4_load(gb, gamma);
        fr4_inv_mont(gamma, gamma_inv);
        // x = x_L + gamma_inv * x_R
        for (size_t i = 0; i < half; ++i) {
            Fr4 t;
            fr4_mont_mul(gamma_inv, x[half + i], t);
            fr4_addmod(x[i], t, x[i]);
        }
        // fold T,U,G by gamma (one call, matching the Python layout)
        uint8_t gk1[16], gk2[16], gn1v, gn2v;
        if (cp_glv_decompose(gb, 1, gk1, &gn1v, gk2, &gn2v) != 0) return 3;
        std::memcpy(foldL.data(), T.data(), 144 * half);
        std::memcpy(foldL.data() + 144 * half, U.data(), 144 * half);
        std::memcpy(foldL.data() + 288 * half, G.data(), 144 * half);
        std::memcpy(foldR.data(), T.data() + 144 * half, 144 * half);
        std::memcpy(foldR.data() + 144 * half, U.data() + 144 * half,
                    144 * half);
        std::memcpy(foldR.data() + 288 * half, G.data() + 144 * half,
                    144 * half);
        cp_dual_mul_norm(foldL.data(), foldR.data(), 3 * half, beta48, gk1,
                         gn1v, gk2, gn2v, 128, foldO.data());
        std::memcpy(T.data(), foldO.data(), 144 * half);
        std::memcpy(U.data(), foldO.data() + 144 * half, 144 * half);
        std::memcpy(G.data(), foldO.data() + 288 * half, 144 * half);
        len = half;
        ++round;
    }
    fr4_store(x[0], x_final, false);
    return 0;
}

// IPA prover rounds (inner_product_argument.rs:150-186). g/gp: n canonical
// 144B blocks each; cs/ds: n canonical 32B LE Fr (already alpha-folded);
// h_pt: the beta-scaled H (144B). out_lr: 4*lg_n blocks round-major
// [L_C,L_D,R_C,R_D]; c_final/d_final: 32B LE.
int32_t cp_ipa_prove_loop(uint8_t *blob, const uint8_t *g_pts,
                          const uint8_t *gp_pts, uint64_t n,
                          const uint8_t *cs, const uint8_t *ds,
                          const uint8_t *h_pt, const uint8_t *beta48,
                          uint8_t *out_lr, uint8_t *c_final,
                          uint8_t *d_final) {
    if (!n || (n & (n - 1))) return 1;
    std::vector<uint8_t> G(g_pts, g_pts + 144 * n);
    std::vector<uint8_t> Gp(gp_pts, gp_pts + 144 * n);
    std::vector<Fr4> c(n), d(n);
    for (uint64_t i = 0; i < n; ++i) {
        fr4_load(cs + 32 * i, c[i]);
        fr4_load(ds + 32 * i, d[i]);
    }

    // per round: 2*len + 2 scalars ([c_L | ip1 | d_R | c_R | ip2 | d_L])
    const size_t cap = 2 * n + 2;
    std::vector<uint8_t> sc(32 * cap), k1(16 * cap), k2(16 * cap), n1(cap),
        n2(cap);
    std::vector<uint8_t> mpts(144 * cap), outs(4 * 144), comp(4 * 48);
    std::vector<uint32_t> mid(cap);
    std::vector<uint8_t> foldO(144 * n);

    size_t len = n;
    int round = 0;
    while (len > 1) {
        size_t half = len / 2;
        // ip1 = <c_L, d_R>, ip2 = <c_R, d_L> (Montgomery accumulate)
        Fr4 ip1 = {{0, 0, 0, 0}}, ip2 = {{0, 0, 0, 0}};
        for (size_t i = 0; i < half; ++i) {
            Fr4 t;
            fr4_mont_mul(c[i], d[half + i], t);
            fr4_addmod(ip1, t, ip1);
            fr4_mont_mul(c[half + i], d[i], t);
            fr4_addmod(ip2, t, ip2);
        }
        // scalar layout: [c_L (half) | ip1 | d_R (half) | c_R (half) | ip2 | d_L (half)]
        size_t o = 0;
        for (size_t i = 0; i < half; ++i)
            fr4_store(c[i], sc.data() + 32 * o++, false);
        fr4_store(ip1, sc.data() + 32 * o++, false);
        for (size_t i = 0; i < half; ++i)
            fr4_store(d[half + i], sc.data() + 32 * o++, false);
        for (size_t i = 0; i < half; ++i)
            fr4_store(c[half + i], sc.data() + 32 * o++, false);
        fr4_store(ip2, sc.data() + 32 * o++, false);
        for (size_t i = 0; i < half; ++i)
            fr4_store(d[i], sc.data() + 32 * o++, false);
        size_t m = o;  // == len + 2
        if (cp_glv_decompose(sc.data(), m, k1.data(), n1.data(), k2.data(),
                             n2.data()) != 0)
            return 2;
        // points aligned with the scalars; groups 0..3 -> L_C, L_D, R_C, R_D
        o = 0;
        std::memcpy(mpts.data() + 144 * o, G.data() + 144 * half, 144 * half);
        for (size_t i = 0; i < half; ++i) mid[o++] = 0;   // (G_R, c_L)
        std::memcpy(mpts.data() + 144 * o, h_pt, 144);
        mid[o++] = 0;                                      // (H, ip1)
        std::memcpy(mpts.data() + 144 * o, Gp.data(), 144 * half);
        for (size_t i = 0; i < half; ++i) mid[o++] = 1;   // (Gp_L, d_R)
        std::memcpy(mpts.data() + 144 * o, G.data(), 144 * half);
        for (size_t i = 0; i < half; ++i) mid[o++] = 2;   // (G_L, c_R)
        std::memcpy(mpts.data() + 144 * o, h_pt, 144);
        mid[o++] = 2;                                      // (H, ip2)
        std::memcpy(mpts.data() + 144 * o, Gp.data() + 144 * half, 144 * half);
        for (size_t i = 0; i < half; ++i) mid[o++] = 3;   // (Gp_R, d_L)
        cp_msm_glv_many(mpts.data(), m, k1.data(), n1.data(), k2.data(),
                        n2.data(), beta48, mid.data(), 4, outs.data());
        cp_batch_normalize(outs.data(), 4);
        std::memcpy(out_lr + 4 * 144 * (size_t)round, outs.data(), 4 * 144);
        for (int g = 0; g < 4; ++g)
            g1_compress_canonical(outs.data() + 144 * g, comp.data() + 48 * g);
        cp_strobe_append_many(blob, (const uint8_t *)"ipa_loop", 8,
                              comp.data(), 48, 4);
        uint8_t gb[32];
        cp_transcript_challenges(blob, (const uint8_t *)"ipa_gamma", 9, 1, gb);
        Fr4 gamma, gamma_inv;
        fr4_load(gb, gamma);
        fr4_inv_mont(gamma, gamma_inv);
        // c = c_L + gamma_inv * c_R ; d = d_L + gamma * d_R
        for (size_t i = 0; i < half; ++i) {
            Fr4 t;
            fr4_mont_mul(gamma_inv, c[half + i], t);
            fr4_addmod(c[i], t, c[i]);
            fr4_mont_mul(gamma, d[half + i], t);
            fr4_addmod(d[i], t, d[i]);
        }
        // G folds by gamma, G' by gamma_inv (two shared-scalar folds)
        uint8_t gk1[16], gk2[16], gn1v, gn2v;
        if (cp_glv_decompose(gb, 1, gk1, &gn1v, gk2, &gn2v) != 0) return 3;
        cp_dual_mul_norm(G.data(), G.data() + 144 * half, half, beta48, gk1,
                         gn1v, gk2, gn2v, 128, foldO.data());
        std::memcpy(G.data(), foldO.data(), 144 * half);
        uint8_t gib[32];
        fr4_store(gamma_inv, gib, false);
        if (cp_glv_decompose(gib, 1, gk1, &gn1v, gk2, &gn2v) != 0) return 3;
        cp_dual_mul_norm(Gp.data(), Gp.data() + 144 * half, half, beta48, gk1,
                         gn1v, gk2, gn2v, 128, foldO.data());
        std::memcpy(Gp.data(), foldO.data(), 144 * half);
        len = half;
        ++round;
    }
    fr4_store(c[0], c_final, false);
    fr4_store(d[0], d_final, false);
    (void)kMaxLg;
    return 0;
}

}  // extern "C"

// ---- microbenchmark hook (perf work only; no protocol use) ----
// Times `iters` ops of one kind, returns wall ns.  Latency kinds run one
// dependency chain; throughput kinds run 4 independent chains.  Results are
// accumulated into a sink so nothing is dead-code-eliminated.
extern "C" uint64_t cp_ifma_bench(int32_t kind, uint64_t iters) {
#if CP_HAVE_IFMA
    using namespace ifma;
    uint64_t seed = 0x9e3779b97f4a7c15ULL;
    auto next = [&seed]() {
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        return seed;
    };
    Fq a[8], b[8];
    for (int k = 0; k < 8; ++k) {
        for (int j = 0; j < 6; ++j) { a[k].l[j] = next(); b[k].l[j] = next(); }
        a[k].l[5] &= (1ULL << 61) - 1;
        b[k].l[5] &= (1ULL << 61) - 1;
        while (fq_geq_p(a[k])) fq_sub_p(a[k]);
        while (fq_geq_p(b[k])) fq_sub_p(b[k]);
    }
    u64 pa[64], pb[64];
    convert_to52_batch(a, 8, pa);
    convert_to52_batch(b, 8, pb);
    const u64 *sa[8], *sb[8];
    for (int k = 0; k < 8; ++k) { sa[k] = pa + 8 * k; sb[k] = pb + 8 * k; }
    Fq8 va, vb;
    load8(sa, va);
    load8(sb, vb);
    Fq8 r0 = va, r1 = vb, r2 = va, r3 = vb;
    Jac8 p[4];
    for (int g = 0; g < 4; ++g) { p[g].X = va; p[g].Y = vb; p[g].Z = va; }
    auto t0 = std::chrono::steady_clock::now();
    switch (kind) {
    case 0:  // montmul8 latency chain
        for (uint64_t i = 0; i < iters; ++i) montmul8(r0, vb, r0);
        break;
    case 1:  // montmul8 throughput (4 chains)
        for (uint64_t i = 0; i < iters; i += 4) {
            montmul8(r0, vb, r0); montmul8(r1, vb, r1);
            montmul8(r2, vb, r2); montmul8(r3, vb, r3);
        }
        break;
    case 2:  // sqr8 latency chain
        for (uint64_t i = 0; i < iters; ++i) sqr8(r0, r0);
        break;
    case 3:  // add8 latency chain
        for (uint64_t i = 0; i < iters; ++i) add8(r0, vb, r0);
        break;
    case 4:  // sub8 latency chain
        for (uint64_t i = 0; i < iters; ++i) sub8(r0, vb, r0);
        break;
    case 5:  // add8 throughput (4 chains)
        for (uint64_t i = 0; i < iters; i += 4) {
            add8(r0, vb, r0); add8(r1, vb, r1);
            add8(r2, vb, r2); add8(r3, vb, r3);
        }
        break;
    case 6:  // jacobian double, K=1 (one group chain)
        for (uint64_t i = 0; i < iters; ++i) dbl_jacK<1>(p);
        break;
    case 7:  // jacobian double, K=3 interleave (counts 3 doublings/call)
        for (uint64_t i = 0; i < iters; i += 3) dbl_jacK<3>(p);
        break;
    case 8:  // jacobian add, K=1
        for (uint64_t i = 0; i < iters; ++i) add_jacK<1>(p, p + 1);
        break;
    case 9:  // jacobian add, K=3
        for (uint64_t i = 0; i < iters; i += 3) add_jacK<3>(p, p + 1);
        break;
    case 10:  // the halved-cross-term square schedule (superseded)
        for (uint64_t i = 0; i < iters; ++i) _sqr8_halved(r0, r0);
        break;
    default:
        return 0;
    }
    auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now() - t0).count();
    // sink
    u64 out[64];
    u64 *dr[8];
    for (int k = 0; k < 8; ++k) dr[k] = out + 8 * k;
    add8(r0, r1, r0); add8(r2, r3, r2); add8(r0, r2, r0);
    add8(r0, p[0].X, r0); add8(r0, p[0].Y, r0); add8(r0, p[0].Z, r0);
    store8(r0, dr);
    volatile u64 sink = 0;
    for (int j = 0; j < 64; ++j) sink += out[j];
    (void)sink;
    return (uint64_t)ns;
#else
    (void)kind; (void)iters;
    return 0;
#endif
}
