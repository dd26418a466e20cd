/* The reference's plain arithmetic: BLS12-381 G1 in Jacobian coordinates
 * over six 64-bit Montgomery limbs, a textbook double-and-add scalar
 * multiplication, one bucket-method MSM, and the two permutations the
 * transcript and the RNG need (Keccak-f[1600], ChaCha12).  No
 * endomorphism, no signed digits, no vector units.  Points cross the
 * boundary as canonical little-endian x, y, z (48 bytes each, z = 0 at
 * infinity), scalars as canonical little-endian 32 bytes.
 * `constants.h` (P, P_INV, R2) is generated by `plain.py`. */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;

#include "constants.h"

typedef struct { u64 x[6], y[6], z[6]; } pt;

static int is_zero(const u64 *a) {
    u64 acc = 0;
    for (int i = 0; i < 6; i++) acc |= a[i];
    return acc == 0;
}

static int geq_p(const u64 *a) {
    for (int i = 5; i >= 0; i--)
        if (a[i] != P[i]) return a[i] > P[i];
    return 1;
}

static void sub_p(u64 *a) {
    u64 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 t = (u128)a[i] - P[i] - borrow;
        a[i] = (u64)t;
        borrow = (u64)(t >> 64) & 1;
    }
}

static void fp_add(u64 *r, const u64 *a, const u64 *b) {
    u64 c = 0;
    for (int i = 0; i < 6; i++) {
        u128 t = (u128)a[i] + b[i] + c;
        r[i] = (u64)t;
        c = (u64)(t >> 64);
    }
    if (geq_p(r)) sub_p(r);
}

static void fp_sub(u64 *r, const u64 *a, const u64 *b) {
    u64 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 t = (u128)a[i] - b[i] - borrow;
        r[i] = (u64)t;
        borrow = (u64)(t >> 64) & 1;
    }
    if (borrow) {
        u64 c = 0;
        for (int i = 0; i < 6; i++) {
            u128 t = (u128)r[i] + P[i] + c;
            r[i] = (u64)t;
            c = (u64)(t >> 64);
        }
    }
}

/* Montgomery product a * b / 2^384 mod P (CIOS). */
static void fp_mul(u64 *r, const u64 *a, const u64 *b) {
    u64 t[8] = {0};
    for (int i = 0; i < 6; i++) {
        u128 c = 0;
        for (int j = 0; j < 6; j++) {
            c += (u128)a[j] * b[i] + t[j];
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[6];
        t[6] = (u64)c;
        t[7] = (u64)(c >> 64);
        u64 m = t[0] * P_INV;
        c = ((u128)m * P[0] + t[0]) >> 64;
        for (int j = 1; j < 6; j++) {
            c += (u128)m * P[j] + t[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[6];
        t[5] = (u64)c;
        t[6] = t[7] + (u64)(c >> 64);
    }
    memcpy(r, t, 48);
    if (t[6] || geq_p(r)) sub_p(r);
}

static void dbl(pt *r, const pt *p) {           /* dbl-2009-l, a = 0 */
    u64 a[6], b[6], c[6], d[6], e[6], f[6], t[6];
    if (is_zero(p->z)) { *r = *p; return; }
    fp_mul(a, p->x, p->x);
    fp_mul(b, p->y, p->y);
    fp_mul(c, b, b);
    fp_add(t, p->x, b);
    fp_mul(d, t, t);
    fp_sub(d, d, a);
    fp_sub(d, d, c);
    fp_add(d, d, d);
    fp_add(e, a, a);
    fp_add(e, e, a);
    fp_mul(f, e, e);
    u64 z3[6];
    fp_mul(z3, p->y, p->z);
    fp_add(z3, z3, z3);
    fp_sub(r->x, f, d);
    fp_sub(r->x, r->x, d);
    fp_sub(t, d, r->x);
    fp_mul(r->y, e, t);
    fp_add(c, c, c);
    fp_add(c, c, c);
    fp_add(c, c, c);
    fp_sub(r->y, r->y, c);
    memcpy(r->z, z3, 48);
}

static void add(pt *r, const pt *p, const pt *q) {   /* add-2007-bl */
    if (is_zero(p->z)) { *r = *q; return; }
    if (is_zero(q->z)) { *r = *p; return; }
    u64 z1z1[6], z2z2[6], u1[6], u2[6], s1[6], s2[6], h[6], i[6], j[6],
        rr[6], v[6], t[6];
    fp_mul(z1z1, p->z, p->z);
    fp_mul(z2z2, q->z, q->z);
    fp_mul(u1, p->x, z2z2);
    fp_mul(u2, q->x, z1z1);
    fp_mul(s1, p->y, q->z);
    fp_mul(s1, s1, z2z2);
    fp_mul(s2, q->y, p->z);
    fp_mul(s2, s2, z1z1);
    fp_sub(h, u2, u1);
    fp_sub(rr, s2, s1);
    if (is_zero(h)) {
        if (is_zero(rr)) { dbl(r, p); return; }
        memset(r, 0, sizeof(*r));
        return;
    }
    fp_add(i, h, h);
    fp_mul(i, i, i);
    fp_mul(j, h, i);
    fp_add(rr, rr, rr);
    fp_mul(v, u1, i);
    pt out;
    fp_mul(out.x, rr, rr);
    fp_sub(out.x, out.x, j);
    fp_sub(out.x, out.x, v);
    fp_sub(out.x, out.x, v);
    fp_sub(t, v, out.x);
    fp_mul(out.y, rr, t);
    fp_mul(t, s1, j);
    fp_add(t, t, t);
    fp_sub(out.y, out.y, t);
    fp_add(t, p->z, q->z);
    fp_mul(t, t, t);
    fp_sub(t, t, z1z1);
    fp_sub(t, t, z2z2);
    fp_mul(out.z, t, h);
    *r = out;
}

static void load_fp(u64 *r, const uint8_t *b) {
    u64 a[6];
    memcpy(a, b, 48);
    fp_mul(r, a, R2);
}

static void store_fp(uint8_t *b, const u64 *a) {
    static const u64 one[6] = {1, 0, 0, 0, 0, 0};
    u64 r[6];
    fp_mul(r, a, one);
    memcpy(b, r, 48);
}

static void load_pt(pt *p, const uint8_t *b) {
    load_fp(p->x, b);
    load_fp(p->y, b + 48);
    load_fp(p->z, b + 96);
}

static void store_pt(uint8_t *b, const pt *p) {
    if (is_zero(p->z)) { memset(b, 0, 144); return; }
    store_fp(b, p->x);
    store_fp(b + 48, p->y);
    store_fp(b + 96, p->z);
}

static int bit(const uint8_t *s, int i) { return (s[i >> 3] >> (i & 7)) & 1; }

static void mul(pt *r, const pt *p, const uint8_t *s) {
    pt acc;
    memset(&acc, 0, sizeof(acc));
    for (int i = 255; i >= 0; i--) {
        dbl(&acc, &acc);
        if (bit(s, i)) add(&acc, &acc, p);
    }
    *r = acc;
}

/* out[i] = s[i] * p[i] */
void pr_mul_each(const uint8_t *pts, const uint8_t *sc, u64 n, uint8_t *out) {
    for (u64 i = 0; i < n; i++) {
        pt p, r;
        load_pt(&p, pts + 144 * i);
        mul(&r, &p, sc + 32 * i);
        store_pt(out + 144 * i, &r);
    }
}

/* out[i] = a[i] + s[i] * b[i] */
void pr_fold_each(const uint8_t *a, const uint8_t *b, const uint8_t *sc, u64 n,
                  uint8_t *out) {
    for (u64 i = 0; i < n; i++) {
        pt pa, pb, r;
        load_pt(&pa, a + 144 * i);
        load_pt(&pb, b + 144 * i);
        mul(&r, &pb, sc + 32 * i);
        add(&r, &r, &pa);
        store_pt(out + 144 * i, &r);
    }
}

/* sum of s[i] * p[i]: the bucket method, windows of c bits from the top */
void pr_msm(const uint8_t *pts, const uint8_t *sc, u64 n, uint8_t *out) {
    int c = 1;
    while ((1ULL << (c + 2)) < n && c < 16) c++;
    pt *base = malloc(n * sizeof(pt));
    pt *bucket = malloc(((size_t)1 << c) * sizeof(pt));
    for (u64 i = 0; i < n; i++) load_pt(&base[i], pts + 144 * i);
    pt total;
    memset(&total, 0, sizeof(total));
    int windows = (256 + c - 1) / c;
    for (int w = windows - 1; w >= 0; w--) {
        for (int k = 0; k < c; k++) dbl(&total, &total);
        memset(bucket, 0, ((size_t)1 << c) * sizeof(pt));
        for (u64 i = 0; i < n; i++) {
            unsigned d = 0;
            for (int k = c - 1; k >= 0; k--) {
                int b = w * c + k;
                d = (d << 1) | (b < 256 ? bit(sc + 32 * i, b) : 0);
            }
            if (d) add(&bucket[d], &bucket[d], &base[i]);
        }
        pt run, acc;
        memset(&run, 0, sizeof(run));
        memset(&acc, 0, sizeof(acc));
        for (long d = (1L << c) - 1; d >= 1; d--) {
            add(&run, &run, &bucket[d]);
            add(&acc, &acc, &run);
        }
        add(&total, &total, &acc);
    }
    store_pt(out, &total);
    free(base);
    free(bucket);
}

/* Keccak-f[1600] on 25 little-endian lanes, in place */
void pr_keccak_f1600(u64 *a) {
    static const u64 rc[24] = {
        0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
        0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
        0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
        0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
        0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
        0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
        0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
        0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
    static const int rot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
    for (int round = 0; round < 24; round++) {
        u64 c[5], b[25];
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++) {
            u64 d = c[(x + 4) % 5] ^ ((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63));
            for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
        }
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) {
                u64 v = a[x + 5 * y];
                int n = rot[x + 5 * y];
                b[y + 5 * ((2 * x + 3 * y) % 5)] = n ? (v << n) | (v >> (64 - n)) : v;
            }
        for (int y = 0; y < 25; y += 5)
            for (int x = 0; x < 5; x++)
                a[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
        a[0] ^= rc[round];
    }
}

/* four ChaCha12 blocks from `counter` on: rand_chacha's BlockRng refill */
void pr_chacha12_four_blocks(const uint32_t key[8], u64 counter, uint32_t out[64]) {
#define ROTL(v, r) (((v) << (r)) | ((v) >> (32 - (r))))
#define QR(a, b, c, d)                                     \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = ROTL(x[d], 16);     \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = ROTL(x[b], 12);     \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = ROTL(x[d], 8);      \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = ROTL(x[b], 7)
    for (int blk = 0; blk < 4; blk++) {
        u64 ctr = counter + (u64)blk;
        uint32_t st[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                           key[0], key[1], key[2], key[3], key[4], key[5], key[6],
                           key[7], (uint32_t)ctr, (uint32_t)(ctr >> 32), 0, 0};
        uint32_t x[16];
        memcpy(x, st, sizeof(x));
        for (int r = 0; r < 6; r++) {
            QR(0, 4, 8, 12); QR(1, 5, 9, 13); QR(2, 6, 10, 14); QR(3, 7, 11, 15);
            QR(0, 5, 10, 15); QR(1, 6, 11, 12); QR(2, 7, 8, 13); QR(3, 4, 9, 14);
        }
        for (int i = 0; i < 16; i++) out[blk * 16 + i] = x[i] + st[i];
    }
#undef QR
#undef ROTL
}
