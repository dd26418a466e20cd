"""The carry-chain field core (`csrc/fq_cc.cuh`) of every kernel, through
its portable C twin, on the CPU.

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
  (0, 0, 0) padding rows;
- two identities of the full-add fold (`csrc/g1_fold.cuh`): the mixed
  add equals the complete add at z2 = one, and its scale `cc::g1_add_inf`
  equals the complete add of (0 : y2 : 0), for y2 = one, q - one, 0 and
  random values, with P at infinity, P = +-Q and all-zero P among the
  cases;
- the bucket folds' slot loop with either row step, the repack included,
  against `g1_fold_madd_plain` and `g1_fold_packed_plain`, on plans with
  live rows, input infinities and their negations, the sentinel, all-dead
  slots and a dead row whose x is not 0;
- the lane loop of `csrc/g1_fold_rows.cuh` against `g1_fold_rows_plain` on
  rows with a general z, z = 0 rows and infinities, at T = 1 and 5.

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
#include "g1_fold.cuh"
#include "g1_fold_rows.cuh"
#include <vector>

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

// P + (0 : y2 : 0) by the full-add fold's scale
extern "C" void cc_add_inf(const uint32_t* p, const uint32_t* y2,
                           uint32_t* out, long n) {
  for (long k = 0; k < n; ++k) {
    const uint32_t* pk = p + 36 * k;
    cc::Proj a{get(pk), get(pk + 12), get(pk + 24)};
    cc::Proj r = cc::g1_add_inf(a, get(y2 + 12 * k));
    put(out + 36 * k, r.x);
    put(out + 36 * k + 12, r.y);
    put(out + 36 * k + 24, r.z);
  }
}

// the bucket fold as its kernel runs it: repack [12, E] pairs into the
// [E, 24] scratch, then slot by slot with the row step of g1_fold_packed
// (full != 0) or g1_fold_madd; out [3, 24, s_pad]
extern "C" void cc_fold(int full, const uint32_t* px, const uint32_t* py,
                        const uint32_t* zb, const int32_t* plan, long n_ext,
                        int t_rows, long s_pad, uint32_t* out) {
  std::vector<uint32_t> pts(24 * n_ext);
  for (long e = 0; e < n_ext; ++e)
    cc::repack_point(px, py, n_ext, e, pts.data());
  for (long s = 0; s < s_pad; ++s) {
    cc::Proj a =
        full ? cc::fold_slot<cc::FullRow>(pts.data(), zb, plan, t_rows, s_pad, s)
             : cc::fold_slot<cc::MaddRow>(pts.data(), zb, plan, t_rows, s_pad, s);
    cc::store16(out, s_pad, s, a.x);
    cc::store16(out + 24 * s_pad, s_pad, s, a.y);
    cc::store16(out + 48 * s_pad, s_pad, s, a.z);
  }
}

// [24, T, S] rows -> out [3, 24, S], column by column
extern "C" void cc_fold_rows(const uint32_t* x, const uint32_t* y,
                             const uint32_t* z, int t_rows, long s,
                             uint32_t* out) {
  for (long lane = 0; lane < s; ++lane) {
    cc::Proj a = cc::fold_rows_lane(x, y, z, t_rows, s, lane);
    cc::store16(out, s, lane, a.x);
    cc::store16(out + 24 * s, s, lane, a.y);
    cc::store16(out + 48 * s, s, lane, a.z);
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
    h.cc_add_inf.argtypes = [p, p, p, ctypes.c_long]
    h.cc_fold.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_long,
                          ctypes.c_int, ctypes.c_long, p]
    h.cc_fold_rows.argtypes = [p, p, p, ctypes.c_int, ctypes.c_long, p]
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


def _proj_words(cols) -> np.ndarray:
    """[x, y, z] Montgomery int columns -> [n, 3, 12] uint32, the harness's
    point layout."""
    return np.ascontiguousarray(np.stack([_words(c) for c in cols], axis=1))


def _special_ps(r: np.random.Generator, qs) -> list:
    """P for the identity tests: seeded points, infinity, P = Q and P = -Q
    (against the first two of `qs`), and None, an all-zero (0, 0, 0) row."""
    ps = [GENERATOR.mul(int(k)) for k in r.integers(1, 2**62, size=20)]
    return ps + [G1.infinity(), qs[0], qs[1].neg(), None]


def test_mixed_add_is_the_complete_add_at_z_one(lib):
    """Identity 1: `cc::g1_madd(P, x2, y2)` writes the words of
    `cc::g1_add(P, (x2, y2, one))`, also for (x2, y2) on no curve."""
    r = np.random.default_rng(60)
    qs = [GENERATOR.mul(int(k)) for k in r.integers(1, 2**62, size=24)]
    ps = _special_ps(r, qs)
    q_aff = [q.to_affine() for q in qs[:len(ps) - 3]]
    q_aff += [tuple(int(v) % Q for v in r.integers(0, 2**63, size=2))
              for _ in range(3)]
    lam = [int(v) for v in r.integers(1, 2**63, size=len(ps))]
    p_in = _proj_words(_projective(ps, lam))
    qx, qy = ([FQ.to_mont(c) for c in col] for col in zip(*q_aff))
    xy = np.ascontiguousarray(np.stack([_words(qx), _words(qy)], axis=1))
    out_m, out_a = np.zeros_like(p_in), np.zeros_like(p_in)
    lib.cc_madd(_ptr(p_in), _ptr(xy), _ptr(out_m), len(ps))
    q_in = _proj_words([qx, qy, [R_MOD_Q] * len(ps)])
    lib.cc_add(_ptr(p_in), _ptr(q_in), _ptr(out_a), len(ps))
    assert np.array_equal(out_m, out_a)


def test_scale_is_the_complete_add_of_an_infinity(lib):
    """Identity 2: `cc::g1_add_inf(P, y2)` writes the words of
    `cc::g1_add(P, (0, y2, 0))` for y2 = one, q - one (3 products), 0 and
    random values (5)."""
    r = np.random.default_rng(61)
    qs = [GENERATOR.mul(int(k)) for k in r.integers(1, 2**62, size=2)]
    ps = _special_ps(r, qs)
    lam = [int(v) for v in r.integers(1, 2**63, size=len(ps))]
    p_cols = _projective(ps, lam)
    rand = [int(v) % Q for v in r.integers(0, 2**63, size=len(ps))]
    p_in = _proj_words(p_cols)
    for y2 in ([R_MOD_Q], [Q - R_MOD_Q], [0], rand):
        ys = [y2[k % len(y2)] for k in range(len(ps))]
        q_in = _proj_words([[0] * len(ps), ys, [0] * len(ps)])
        out_s, out_a = np.zeros_like(p_in), np.zeros_like(p_in)
        lib.cc_add_inf(_ptr(p_in), _ptr(_words(ys)), _ptr(out_s), len(ps))
        lib.cc_add(_ptr(p_in), _ptr(q_in), _ptr(out_a), len(ps))
        assert np.array_equal(out_s, out_a)


def _fold_inputs(t_rows: int, s: int, seed: int):
    """Resident bases [P | -P | inf] (CPU tensors) of 40 seeded points, two
    of them infinity, one base (and its negation) with its liveness bit
    cleared though its x is not 0; and a [T, S] plan over them with live
    prefixes, stray dead rows, the sentinel, an all-dead slot, a slot of
    one base T times, P then -P, the input infinities and their negations,
    and the dead row whose x is not 0."""
    from curdleproofs_tpu_torch.ops import msm_device as md

    r = np.random.default_rng(seed)
    pts = [GENERATOR.mul(int(k)) for k in r.integers(1, 2**62, size=40)]
    pts[6] = pts[13] = G1.infinity()
    b = md.DeviceBases(pts, "cpu")
    n = b.n
    zb = b.ext_zb.clone()
    zb[[3, 3 + n]] = 0
    plan = r.integers(0, 2 * n + 1, size=(t_rows, s))
    lengths = r.integers(0, t_rows + 1, size=s)
    plan[np.arange(t_rows)[:, None] >= lengths[None, :]] = 2 * n
    plan[r.random((t_rows, s)) < 0.05] = 2 * n
    plan[:, 0] = 2 * n                             # an all-dead slot
    plan[:, 1] = 5                                 # one base T times
    plan[:, 2] = [7, 7 + n] * (t_rows // 2) + [7] * (t_rows % 2)
    plan[:, 3] = [6, 6 + n, 13 + n, 9] * (t_rows // 4) + [9] * (t_rows % 4)
    plan[0, 4], plan[-1, 5] = 3, 3 + n             # dead, x != 0
    return b.ext_px, b.ext_py, zb, torch.from_numpy(plan.astype(np.int32))


@pytest.mark.parametrize("full", [False, True], ids=["madd", "packed"])
@pytest.mark.parametrize("t_rows, s", [(8, 37), (5, 9)])
def test_fold_slot_loop_matches_plain_version(lib, full, t_rows, s):
    """The bucket folds as their kernels run them (repack, slot loop, row
    step), against `g1_fold_packed_plain` (`cc::FullRow`: every row's words
    of the complete add) and `g1_fold_madd_plain` (`cc::MaddRow`)."""
    ext_px, ext_py, zb, plan = _fold_inputs(t_rows, s, seed=62 + t_rows)
    n_ext = ext_px.shape[1]
    ins = [np.ascontiguousarray(t.numpy()) for t in (ext_px, ext_py, zb, plan)]
    out = np.zeros((3, FQ_LIMBS, s), dtype=np.uint32)
    lib.cc_fold(int(full), *map(_ptr, ins), n_ext, t_rows, s, _ptr(out))
    plain = K.g1_fold_packed_plain if full else K.g1_fold_madd_plain
    want = plain(ext_px, ext_py, zb, plan)
    for k, w in enumerate(want):
        assert np.array_equal(out[k], w.numpy().astype(np.uint32))


@pytest.mark.parametrize("t_rows", [1, 5])
def test_fold_rows_lane_matches_plain_version(lib, t_rows):
    """`cc::fold_rows_lane` against `g1_fold_rows_plain` on [24, T, 37]
    rows: general z, z = 0 (dead) rows, infinities (0 : l : 0) and all-zero
    rows, P then -P down a column."""
    r = np.random.default_rng(70 + t_rows)
    s = 37
    cells = [GENERATOR.mul(int(k))
             for k in r.integers(1, 2**62, size=t_rows * s)]
    for i in range(0, len(cells), 7):
        cells[i] = G1.infinity()
    cells[3] = None
    if t_rows > 1:
        cells[s + 1] = cells[1].neg()              # column 1: P, then -P
    lam = [int(v) for v in r.integers(1, 2**63, size=len(cells))]
    xyz = [_limbs16(c).reshape(FQ_LIMBS, t_rows, s)
           for c in _projective(cells, lam)]
    xyz[2][:, :, 5::6] = 0                         # dead rows: z = 0
    rows = [np.ascontiguousarray(c.numpy().astype(np.uint32)) for c in xyz]
    out = np.zeros((3, FQ_LIMBS, s), dtype=np.uint32)
    lib.cc_fold_rows(*map(_ptr, rows), t_rows, s, _ptr(out))
    want = K.g1_fold_rows_plain(*(c.int() for c in xyz))
    for k, w in enumerate(want):
        assert np.array_equal(out[k], w.numpy().astype(np.uint32))
