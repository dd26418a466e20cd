"""The carry-chain field core (`csrc/fq_cc.cuh`) of the bucket fold, the
complete add, the square root and the bucket reduction's suffix chain,
through its portable C twin, on the CPU.

The header compiles its PTX primitives only for the card; any other compiler
gets the twin: the same chains with the carry flag kept in a variable.  A
small harness over the header is built here with g++ and checked:
- 10,000 seeded Montgomery products, sums and differences against Python
  integers (x * y * 2^-384 mod q, (x + y) mod q, (x - y) mod q), with the
  edge values 0, 1, q - 1 and R mod q;
- the mixed add `cc::g1_madd` against the port's `g1_madd64` (the plain
  version the fold kernel is held to) on the same points, including P at
  infinity, P = Q and P = -Q;
- the complete add `cc::g1_add` against `g1_add64` (the plain version of
  the g1_add kernel) with both points in general projective form: both at
  infinity, one at infinity, P = Q, P = -Q and the all-zero (0, 0, 0) rows
  of the reference's padding;
- the square-root chain of `csrc/g1_sqrt.cuh` (with the generated
  `sqrt_constants.h`) against `g1_sqrt_plain`, on the x of seeded points,
  the identity lane's x = 0 and x that are no curve point's;
- the suffix chain of `csrc/g1_suffix_weighted.cuh` (the chain entry's
  `cc::suffix_weighted_lane`, reading the kernel's [24, Cb, WG] rows)
  against `g1_suffix_weighted_plain` at Cb = 1, 3, 8 and 16, with buckets
  at infinity, P beside -P, one point repeated down a lane and all-zero
  (0, 0, 0) padding rows.

Tolerance: exact (canonical residues, array equality).  The PTX path itself
is held only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from curdleproofs_tpu_torch.constants import Q
from curdleproofs_tpu_torch.host.g1 import G1, GENERATOR
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ, g1_add64, g1_madd64
from curdleproofs_tpu_torch.ops.limbs import FQ_LIMBS, ints_to_limbs

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "curdleproofs_tpu_torch" \
    / "csrc"
R_MOD_Q = (1 << 384) % Q

_HARNESS = r"""
#include "fq_cc.cuh"
#include "g1_sqrt.cuh"
#include "g1_suffix_weighted.cuh"

static cc::Fq get(const uint32_t* p) {
  cc::Fq r;
  for (int i = 0; i < cc::NL; ++i) r.v[i] = p[i];
  return r;
}
static void put(uint32_t* p, const cc::Fq& a) {
  for (int i = 0; i < cc::NL; ++i) p[i] = a.v[i];
}

extern "C" void cc_field(int op, const uint32_t* a, const uint32_t* b,
                         uint32_t* out, long n) {
  for (long k = 0; k < n; ++k) {
    cc::Fq x = get(a + 12 * k), y = get(b + 12 * k);
    put(out + 12 * k, op == 0 ? cc::fq_mul(x, y)
                    : op == 1 ? cc::fq_add(x, y) : cc::fq_sub(x, y));
  }
}

extern "C" void cc_madd(const uint32_t* p, const uint32_t* q, uint32_t* out,
                        long n) {
  for (long k = 0; k < n; ++k) {
    const uint32_t* pk = p + 36 * k;
    cc::Proj a{get(pk), get(pk + 12), get(pk + 24)};
    cc::Proj r = cc::g1_madd(a, get(q + 24 * k), get(q + 24 * k + 12));
    put(out + 36 * k, r.x);
    put(out + 36 * k + 12, r.y);
    put(out + 36 * k + 24, r.z);
  }
}

extern "C" void cc_add(const uint32_t* p, const uint32_t* q, uint32_t* out,
                       long n) {
  for (long k = 0; k < n; ++k) {
    const uint32_t* pk = p + 36 * k;
    const uint32_t* qk = q + 36 * k;
    cc::Proj a{get(pk), get(pk + 12), get(pk + 24)};
    cc::Proj b{get(qk), get(qk + 12), get(qk + 24)};
    cc::Proj r = cc::g1_add(a, b);
    put(out + 36 * k, r.x);
    put(out + 36 * k + 12, r.y);
    put(out + 36 * k + 24, r.z);
  }
}

extern "C" void cc_sqrt(const uint32_t* x, uint32_t* out, long n) {
  for (long k = 0; k < n; ++k)
    put(out + 12 * k, cc::sqrt_candidate(get(x + 12 * k)));
}

// [24, cb, wg] 16-bit limb rows of x, y, z -> out [6, 24, wg]: total x, y,
// z, then weighted x, y, z, as the kernel stores them
extern "C" void cc_suffix(const uint32_t* x, const uint32_t* y,
                          const uint32_t* z, int cb, long wg, uint32_t* out) {
  for (long lane = 0; lane < wg; ++lane) {
    cc::Proj t, w;
    cc::suffix_weighted_lane(x, y, z, cb, wg, lane, t, w);
    const cc::Fq* c[6] = {&t.x, &t.y, &t.z, &w.x, &w.y, &w.z};
    for (int k = 0; k < 6; ++k) cc::store16(out + k * 24 * wg, wg, lane, *c[k]);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("fq_cc")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    K.write_constants(d)                 # sqrt_constants.h for g1_sqrt.cuh
    so = d / "libharness.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror",
                    "-Wno-unknown-pragmas", "-fno-omit-frame-pointer",
                    "-shared", "-fPIC", "-I", str(CSRC), "-I", str(d),
                    "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    h.cc_field.argtypes = [ctypes.c_int, p, p, p, ctypes.c_long]
    h.cc_madd.argtypes = [p, p, p, ctypes.c_long]
    h.cc_add.argtypes = [p, p, p, ctypes.c_long]
    h.cc_sqrt.argtypes = [p, p, ctypes.c_long]
    h.cc_suffix.argtypes = [p, p, p, ctypes.c_int, ctypes.c_long, p]
    return h


def _words(vals) -> np.ndarray:
    """ints -> [n, 12] uint32 limbs, little-endian."""
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
                     for v in vals], dtype=np.uint32)


def _ints(w: np.ndarray) -> list[int]:
    return [sum(int(x) << (32 * i) for i, x in enumerate(row)) for row in w]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _field(lib, op, xs, ys) -> list[int]:
    a, b = _words(xs), _words(ys)
    out = np.zeros_like(a)
    lib.cc_field(op, _ptr(a), _ptr(b), _ptr(out), len(xs))
    return _ints(out)


def _operands(seed: int, n: int) -> tuple[list[int], list[int]]:
    """n seeded residues each side, then every pair of the edge values."""
    r = np.random.default_rng(seed)
    words = r.integers(0, 2**32, size=(2, n, 12), dtype=np.uint64)
    xs, ys = ([sum(int(w) << (32 * i) for i, w in enumerate(row)) % Q
               for row in side] for side in words)
    edge = [0, 1, Q - 1, R_MOD_Q]
    xs += [a for a in edge for _ in edge]
    ys += [b for _ in edge for b in edge]
    return xs, ys


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_ops_against_python_ints(lib, op):
    xs, ys = _operands({"mul": 1, "add": 2, "sub": 3}[op], 10_000)
    r_inv = pow(1 << 384, -1, Q)
    want = {"mul": lambda x, y: x * y * r_inv % Q,
            "add": lambda x, y: (x + y) % Q,
            "sub": lambda x, y: (x - y) % Q}[op]
    got = _field(lib, ["mul", "add", "sub"].index(op), xs, ys)
    assert got == [want(x, y) for x, y in zip(xs, ys)]


def _limbs16(vals) -> torch.Tensor:
    """Montgomery ints -> [24, n] int64 16-bit limbs (the plain versions'
    layout)."""
    return torch.from_numpy(ints_to_limbs(vals, FQ_LIMBS).T.astype(np.int64))


def _ints16(t: torch.Tensor) -> list[int]:
    a = t.numpy()
    return [sum(int(a[i, k]) << (16 * i) for i in range(FQ_LIMBS))
            for k in range(a.shape[1])]


def test_mixed_add_matches_plain_version(lib):
    r = np.random.default_rng(5)
    g = GENERATOR
    qs = [g.mul(int(k)) for k in r.integers(1, 2**62, size=40)]
    ps = [g.mul(int(k)) for k in r.integers(1, 2**62, size=37)]
    ps += [G1.infinity(), qs[37], qs[38].neg()]   # O, then P = Q and -Q
    lam = [int(v) for v in r.integers(1, 2**63, size=len(ps))]
    # P in a general projective representative, Q affine; Montgomery form
    px, py, pz = ([FQ.to_mont(c * l % Q) for c, l in zip(col, lam)]
                  for col in zip(*[(0, 1, 0) if p.is_infinity()
                                   else (*p.to_affine(), 1) for p in ps]))
    qx, qy = ([FQ.to_mont(c) for c in col]
              for col in zip(*[q.to_affine() for q in qs]))
    n = len(ps)
    p_in = np.ascontiguousarray(np.stack([_words(px), _words(py), _words(pz)],
                                         axis=1))
    q_in = np.ascontiguousarray(np.stack([_words(qx), _words(qy)], axis=1))
    out = np.zeros_like(p_in)
    lib.cc_madd(_ptr(p_in), _ptr(q_in), _ptr(out), n)
    want = g1_madd64(PointsXYZ(_limbs16(px), _limbs16(py), _limbs16(pz)),
                     _limbs16(qx), _limbs16(qy))
    for j, w in enumerate(want):
        assert _ints(out[:, j]) == _ints16(w)


def _projective(points, lam) -> list[list[int]]:
    """Host points -> [x, y, z] Montgomery ints in the representative
    (l x : l y : l z); infinity is (0 : l : 0), None an all-zero row."""
    cols = [(0, 0, 0) if p is None else (0, 1, 0) if p.is_infinity()
            else (*p.to_affine(), 1) for p in points]
    return [[FQ.to_mont(c * l % Q) for c, l in zip(col, lam)]
            for col in zip(*cols)]


def test_complete_add_matches_plain_version(lib):
    r = np.random.default_rng(6)
    g = GENERATOR
    ps = [g.mul(int(k)) for k in r.integers(1, 2**62, size=30)]
    qs = [g.mul(int(k)) for k in r.integers(1, 2**62, size=30)]
    inf = G1.infinity()
    ps += [inf, inf, ps[0], ps[1], ps[2], None, None, ps[3]]
    qs += [inf, qs[0], inf, ps[1], ps[2].neg(), None, qs[1], None]
    n = len(ps)
    lp, lq = ([int(v) for v in r.integers(1, 2**63, size=n)] for _ in "pq")
    p_cols, q_cols = _projective(ps, lp), _projective(qs, lq)
    p_in, q_in = (np.ascontiguousarray(np.stack([_words(c) for c in cols],
                                                axis=1))
                  for cols in (p_cols, q_cols))
    out = np.zeros_like(p_in)
    lib.cc_add(_ptr(p_in), _ptr(q_in), _ptr(out), n)
    want = g1_add64(PointsXYZ(*map(_limbs16, p_cols)),
                    PointsXYZ(*map(_limbs16, q_cols)))
    for j, w in enumerate(want):
        assert _ints(out[:, j]) == _ints16(w)


def test_sqrt_chain_matches_plain_version(lib):
    r = np.random.default_rng(8)
    xs = [GENERATOR.mul(int(k)).to_affine()[0]
          for k in r.integers(1, 2**62, size=24)]
    xs += [0, 1, Q - 1]                  # the identity lane's x, no-points
    xs += [int(v) % Q for v in r.integers(0, 2**63, size=5)]
    xm = [FQ.to_mont(x) for x in xs]
    words = _words(xm)
    out = np.zeros_like(words)
    lib.cc_sqrt(_ptr(words), _ptr(out), len(xm))
    pxp = torch.from_numpy(np.ascontiguousarray(words.T).view(np.int32))
    want = K.g1_sqrt_plain(pxp)
    assert _ints(out) == _ints16(want.long() & 0xFFFF)
    # a point's x gives its y up to sign
    for x, y in zip(xs[:24], _ints(out)):
        yy = FQ.from_mont(y)
        assert yy * yy % Q == (x ** 3 + 4) % Q


def _suffix_lanes(cb: int, seed: int) -> list[list]:
    """Per lane, its Cb buckets (bucket j at index j; None is an all-zero
    row): seeded points; every other bucket at infinity; P beside -P (the
    suffix passes through infinity); one point in every bucket; all-zero
    rows in every third bucket."""
    r = np.random.default_rng(seed)
    pts = [GENERATOR.mul(int(k)) for k in r.integers(1, 2**62, size=2 * cb)]
    inf = G1.infinity()
    p = pts[0]
    pm = [p if j % 2 else p.neg() for j in range(cb)] if cb > 1 else [p]
    return [pts[:cb],
            [inf if j % 2 == 0 else pts[cb + j] for j in range(cb)],
            pm,
            [pts[1]] * cb,
            [None if j % 3 == 0 else pts[cb + j] for j in range(cb)]]


@pytest.mark.parametrize("cb", [1, 3, 8, 16])
def test_suffix_chain_matches_plain_version(lib, cb):
    lanes = _suffix_lanes(cb, seed=40 + cb)
    wg = len(lanes)
    cells = [lanes[lane][j] for j in range(cb) for lane in range(wg)]
    r = np.random.default_rng(50 + cb)
    lam = [int(v) for v in r.integers(1, 2**63, size=len(cells))]
    xyz = [_limbs16(c).reshape(FQ_LIMBS, cb, wg)
           for c in _projective(cells, lam)]
    rows = [np.ascontiguousarray(c.numpy().astype(np.uint32)) for c in xyz]
    out = np.zeros((6, FQ_LIMBS, wg), dtype=np.uint32)
    lib.cc_suffix(*map(_ptr, rows), cb, wg, _ptr(out))
    total, weighted = K.g1_suffix_weighted_plain(*(c.int() for c in xyz))
    for k, w in enumerate((*total, *weighted)):
        assert np.array_equal(out[k], w.numpy().astype(np.uint32))
