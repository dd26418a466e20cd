"""The narrow entries of g1_sqrt.cu and g1_add.cu (the protocol's widths)
on the CPU: their group schedules through fq_cc.cuh's C twin, and the
wrappers' width switches.

A harness over `csrc/g1_sqrt.cuh` (with the generated `sqrt_constants.h`)
and `csrc/g1_add.cuh` is built with g++, each group's exchange a
`cc::LoopExchange` that runs the group's roles in turn in one thread, and
checked:
- the pair entry's chain (`cc::sqrt_pair`: the right-to-left binary method,
  a squaring role and a product role a step) at 2 lanes and at 1, on the x
  of seeded points, the identity lane's x = 0 and x that are no curve
  point's, at n = 1 and 37: array-equal to `g1_sqrt_plain` and to the
  one-thread chain `cc::sqrt_candidate`; and through the compressed ingest
  to the JAX package's, whose y is the jnp twin of `_k_sqrt_candidate`;
- the group entries' add (`cc::add_flat_group`, `cc::add_scan_group`: the
  complete add as two levels of six products) at the kernels' `ADD_G`
  lanes (the flat form also at 1, 2 and 4, the scan form at 1 on
  alternating keys), with the kernels' clamp (groups past the last point
  run it again and store nothing): the flat form array-equal to
  `g1_add_plain` and the JAX package's `_k_g1_add` on points with
  infinities, equal operands (the reduction tail's doubling chain
  `g1_add(s2, s2)`), P + -P and all-zero (0, 0, 0) rows, at n = 1 and 37;
  the scan form to `g1_add_scan_plain` (and `_k_g1_add` under its select)
  on a real c = 8 plan's slot keys, round by round, and on alternating keys
  with strides past the width;
- `sqrt_uses_pair` and `add_uses_group` at their constants, and the
  wrappers' routing on the CPU (the plain versions whatever the width).

Tolerance: exact (canonical residues, array equality).  The kernels
themselves are held on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import ctypes
import random
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops.pallas_kernels import _k_g1_add
from curdleproofs_tpu_torch.constants import Q, R
from curdleproofs_tpu_torch.host.g1 import G1, GENERATOR
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops.g1_ops import (
    PointsXYZ, points_from_device, points_to_device,
)
from curdleproofs_tpu_torch.ops.limbs import FQ_LIMBS

torch.set_num_threads(1)

_HARNESS = r"""
#include "g1_sqrt.cuh"
#include "g1_add.cuh"

template <int G>
void sqrt_pair(const uint32_t* pxp, long n, uint32_t* out) {
  for (long k = 0; k < n; ++k) {
    cc::LoopExchange<G> ex;
    cc::store16(out, n, k, cc::sqrt_pair(ex, cc::load_pairs(pxp, n, k)));
  }
}

// [12, n] packed x -> [24, n] y-candidates: the pair's chain at g lanes
// (g = 1, 2), or the one-thread chain (g = 0)
extern "C" int cc_sqrt(const uint32_t* pxp, long n, uint32_t* out, int g) {
  switch (g) {
    case 0:
      for (long k = 0; k < n; ++k)
        cc::store16(out, n, k, cc::sqrt_candidate(cc::load_pairs(pxp, n, k)));
      return 0;
    case 1: sqrt_pair<1>(pxp, n, out); return 0;
    case 2: sqrt_pair<2>(pxp, n, out); return 0;
  }
  return 1;
}

// The groups of a launch as the kernel numbers them: warps of 32 lanes, a
// group past the last point clamped to it with its stores off.
template <int G, class F>
void groups(long n, F f) {
  const long lanes = (n * G + 31) / 32 * 32;
  for (long pt = 0; pt < lanes / G; ++pt) {
    cc::LoopExchange<G> ex;
    f(ex, pt < n ? pt : n - 1, pt < n);
  }
}

// p, q [3, 24, n] -> out [3, 24, n]
template <int G>
void add_flat(const uint32_t* p, const uint32_t* q, long n, uint32_t* out) {
  const long c = 24 * n;
  groups<G>(n, [&](cc::LoopExchange<G>& ex, long col, bool store) {
    cc::add_flat_group(ex, p, p + c, p + 2 * c, q, q + c, q + 2 * c, out,
                       out + c, out + 2 * c, n, col, store);
  });
}

template <int G>
void add_scan(const uint32_t* v, const int64_t* key, long stride, long n,
              uint32_t* out) {
  const long c = 24 * n;
  groups<G>(n, [&](cc::LoopExchange<G>& ex, long col, bool store) {
    cc::add_scan_group(ex, v, v + c, v + 2 * c, key, stride, n, out, out + c,
                       out + 2 * c, col, store);
  });
}

extern "C" int cc_add(const uint32_t* p, const uint32_t* q, long n,
                      uint32_t* out, int g) {
  switch (g) {
    case 1: add_flat<1>(p, q, n, out); return 0;
    case 2: add_flat<2>(p, q, n, out); return 0;
    case 4: add_flat<4>(p, q, n, out); return 0;
    case 8: add_flat<8>(p, q, n, out); return 0;
  }
  return 1;
}

extern "C" int cc_add_scan(const uint32_t* v, const int64_t* key,
                           long stride, long n, uint32_t* out, int g) {
  switch (g) {
    case 1: add_scan<1>(v, key, stride, n, out); return 0;
    case 8: add_scan<8>(v, key, stride, n, out); return 0;
  }
  return 1;
}
"""


def add_g() -> int:
    """`ADD_G` of csrc/g1_add.cu: the group entries' lanes a point."""
    return int(re.search(r"constexpr int ADD_G = (\d+);",
                         (K.CSRC / "g1_add.cu").read_text()).group(1))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("narrow")
    (d / "harness.cpp").write_text(_HARNESS)
    K.write_constants(d)                 # sqrt_constants.h for g1_sqrt.cuh
    so = d / "libharness.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror",
                    "-Wno-unknown-pragmas", "-fno-omit-frame-pointer",
                    "-shared", "-fPIC", "-I", str(K.CSRC), "-I", str(d),
                    "-o", str(so), str(d / "harness.cpp")], check=True,
                   capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    p, n = ctypes.c_void_p, ctypes.c_long
    h.cc_sqrt.argtypes = [p, n, p, ctypes.c_int]
    h.cc_add.argtypes = [p, p, n, p, ctypes.c_int]
    h.cc_add_scan.argtypes = [p, p, n, n, p, ctypes.c_int]
    for fn in (h.cc_sqrt, h.cc_add, h.cc_add_scan):
        fn.restype = ctypes.c_int
    return h


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy().view(np.uint32))


# --------------------------------------------------------------------------
# g1_sqrt: the pair's chain
# --------------------------------------------------------------------------

SQRT_N = 37


def _sqrt_inputs() -> torch.Tensor:
    """[12, 37] packed Montgomery x (int32 words): the x of seeded points,
    then 0 (the identity lane), 1 and q - 1 (no curve point's) and seeded
    residues."""
    r = np.random.default_rng(30)
    xs = [GENERATOR.mul(int(k)).to_affine()[0]
          for k in r.integers(1, 2**62, size=SQRT_N - 6)]
    xs += [0, 1, Q - 1] + [int(v) % Q for v in r.integers(0, 2**63, size=3)]
    words = np.array([[(FQ.to_mont(x) >> (32 * i)) & 0xFFFFFFFF
                       for x in xs] for i in range(12)], dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32))


def _sqrt_run(lib, pxp: torch.Tensor, g: int) -> np.ndarray:
    words = _u32(pxp)
    n = words.shape[1]
    out = np.zeros((FQ_LIMBS, n), np.uint32)
    assert lib.cc_sqrt(_ptr(words), n, _ptr(out), g) == 0
    return out


@pytest.mark.parametrize("n", [1, SQRT_N])
def test_sqrt_pair_chain_equals_plain(lib, n):
    pxp = _sqrt_inputs()[:, :n].contiguous()
    want = K.g1_sqrt_plain(pxp).numpy().view(np.uint32)
    for g in (2, 1, 0):     # the pair, its roles in one lane, one thread
        assert np.array_equal(_sqrt_run(lib, pxp, g), want), g


def test_sqrt_pair_chain_through_the_ingest_equals_jax(lib, monkeypatch):
    """The pair's y-candidates of 37 seeded points, the identity and a
    negation (64 lanes, the padding dead), taken through the port's
    compressed ingest (sign from the parity bit, dead lanes forced to the
    identity) in place of `g1_sqrt`: array-equal to the JAX package's
    `_ingest_compressed(..., pallas=False)`, whose y comes from the jnp
    twin of `_k_sqrt_candidate`'s chain (as the JAX package's own tests
    run it on the CPU: XLA:CPU does not finish compiling the kernel's
    unrolled row product, and eagerly it takes minutes)."""
    from curdleproofs_tpu.ops import msm_device as jmd
    from curdleproofs_tpu_torch.host import native

    if not native.available():
        pytest.skip("native runtime unavailable")
    rng = StdRng.seed_from_u64(34)
    pts = [rng.rand_g1() for _ in range(SQRT_N)]
    pts += [G1.infinity(), pts[1].neg()]
    px, meta = native.export_mont_x(pts, 64)
    pxp = torch.from_numpy(np.asarray(px, np.uint32).view(np.int32))
    y = _sqrt_run(lib, pxp, 2)
    assert np.array_equal(y, K.g1_sqrt_plain(pxp).numpy().view(np.uint32))
    monkeypatch.setattr(md, "g1_sqrt",
                        lambda t: torch.from_numpy(y.view(np.int32)))
    got = md._ingest_compressed(
        pxp, torch.from_numpy(np.asarray(meta, np.uint32).view(np.int32)))
    want = jmd._ingest_compressed(jnp.asarray(px), jnp.asarray(meta),
                                  pallas=False)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))


def test_sqrt_bits_are_the_exponent():
    e = (Q + 1) // 4
    assert sum(b << i for i, b in enumerate(K.SQRT_BITS)) == e
    assert K.SQRT_BITS[-1] == 1 and len(K.SQRT_BITS) == e.bit_length()
    text = K.constants_text()
    assert f"constexpr int SQRT_NBITS = {len(K.SQRT_BITS)};" in text
    assert ", ".join(map(str, K.SQRT_BITS)) in text


# --------------------------------------------------------------------------
# g1_add: the group's flat and scan forms
# --------------------------------------------------------------------------

def _special_pairs(n: int) -> tuple[PointsXYZ, PointsXYZ]:
    """[24, n] point pairs (general z) with the complete add's special
    cases in the first lanes: infinity with infinity, with P and P with it,
    P + P (the doubling chain), P + -P, an all-zero row on either side and
    both."""
    rng = StdRng.seed_from_u64(31)
    ps = [rng.rand_g1() for _ in range(n + 1)]
    qs = [rng.rand_g1() for _ in range(n + 1)]
    a = points_to_device(ps, "cpu")
    b = points_to_device(qs, "cpu")
    p = K.g1_add_plain(a, b)                     # general z
    q = K.g1_add_plain(b, points_to_device(ps[::-1], "cpu"))
    g = PointsXYZ(*(c[:, n:] for c in p))
    p, q = (PointsXYZ(*(c[:, :n].clone() for c in v)) for v in (p, q))
    inf = points_to_device([G1.infinity()], "cpu")
    neg = points_to_device([points_from_device(g)[0].neg()], "cpu")
    zero = PointsXYZ(*(torch.zeros_like(c) for c in inf))
    cases = [(inf, inf), (inf, g), (g, inf), (g, g), (g, neg), (zero, g),
             (g, zero), (zero, zero)]
    for lane, (x, y) in enumerate(cases[:n]):
        for c, v in zip((*p, *q), (*x, *y)):
            c[:, lane] = v[:, 0]
    return p, q


def _stack(v: PointsXYZ) -> np.ndarray:
    return np.ascontiguousarray(np.stack([_u32(c) for c in v]))


def _jax_add(p: PointsXYZ, q: PointsXYZ) -> np.ndarray:
    """The JAX package's `_k_g1_add` on jnp rows, eagerly (as
    tests/test_g1_madd.py runs its mixed add)."""
    rows = [[jnp.asarray(r) for r in _u32(c)] for c in (*p, *q)]
    out = _k_g1_add(tuple(rows[:3]), tuple(rows[3:]))
    return np.stack([np.stack([np.asarray(r) for r in c])
                     for c in out]).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 37])
def test_add_group_flat_equals_plain_and_jax(lib, n):
    p, q = _special_pairs(n)
    want = _stack(K.g1_add_plain(p, q))
    assert np.array_equal(want, _jax_add(p, q))
    pw, qw = _stack(p), _stack(q)
    for g in sorted({add_g(), 1, 2, 4}):
        out = np.zeros_like(pw)
        assert lib.cc_add(_ptr(pw), _ptr(qw), n, _ptr(out), g) == 0
        assert np.array_equal(out, want), g


def _scan_run(lib, v: PointsXYZ, key: torch.Tensor, stride: int,
              g: int) -> np.ndarray:
    vw = _stack(v)
    kw = np.ascontiguousarray(key.numpy().astype(np.int64))
    out = np.zeros_like(vw)
    assert lib.cc_add_scan(_ptr(vw), _ptr(kw), stride, key.shape[0],
                           _ptr(out), g) == 0
    return out


def test_add_group_scan_on_a_slot_plan(lib):
    """Round by round over a real c = 8 plan's merge (kmax > 2; a bucket's
    slots side by side), each round array-equal to `g1_add_scan_plain` and
    to `_k_g1_add` under the scan's select; the next round takes the
    group's output."""
    rng = StdRng.seed_from_u64(32)
    base = [rng.rand_g1() for _ in range(48)]
    pts = [base[i % 48] for i in range(700)] + [G1.infinity()]
    bases = md.DeviceBases(pts, "cpu")
    rnd = random.Random(32)
    ss = [rnd.randrange(R) for _ in range(len(pts))]
    params = md.pick_params(bases.n, 8)
    limbs = torch.from_numpy(md._scalars_to_limbs(ss, params.n)
                             .astype(np.int32))
    sp = md._slot_plan(md._signed_digits(limbs, params.n, 8), n=params.n,
                       c=8, t_rows=params.t_rows, s_pad=params.s_pad)
    v = K.g1_fold_madd_plain(bases.ext_px, bases.ext_py, bases.ext_zb,
                             sp.plan)
    assert sp.kmax > 2
    n, stride = sp.slot_gkey.shape[0], 1
    while stride < sp.kmax:
        want = K.g1_add_scan_plain(v, sp.slot_gkey, stride)
        idx = torch.arange(n)
        partner = torch.clamp(idx + stride, max=n - 1)
        mask = ((sp.slot_gkey[partner] == sp.slot_gkey)
                & (idx + stride < n)).numpy()
        s = _jax_add(v, PointsXYZ(*(c[:, partner] for c in v)))
        assert np.array_equal(np.where(mask, s, _stack(v)), _stack(want))
        got = _scan_run(lib, v, sp.slot_gkey, stride, add_g())
        assert np.array_equal(got, _stack(want)), stride
        v = PointsXYZ(*(torch.from_numpy(c.view(np.int32)) for c in got))
        stride *= 2


@pytest.mark.parametrize("stride", [1, 2, 36, 37, 64])
def test_add_group_scan_on_alternating_keys(lib, stride):
    """Keys that alternate lane by lane at a ragged width (37), the special
    pairs' points, strides to the width and past it; at 1 lane a group too."""
    p, _ = _special_pairs(37)
    key = (torch.arange(37) % 2).long()
    want = _stack(K.g1_add_scan_plain(p, key, stride))
    for g in (add_g(), 1):
        assert np.array_equal(_scan_run(lib, p, key, stride, g), want)
    if stride % 2:                       # odd strides: nothing merges
        assert np.array_equal(want, _stack(p))


# --------------------------------------------------------------------------
# the width switches
# --------------------------------------------------------------------------

def test_width_switches():
    """The pair entry takes g1_sqrt launches up to SQRT_PAIR_MAX_N points,
    the group entries g1_add and scan launches up to ADD_GROUP_MAX_N lanes:
    the protocol's widths (64-768 fresh bases; 32-512 lanes) go to them,
    the 626k MSM's (655,360 bases; 1,835,520 slots, 32,768 chunks) and the
    table's 262,144 multiples to one thread a point."""
    assert K.sqrt_uses_pair(1) and K.sqrt_uses_pair(K.SQRT_PAIR_MAX_N)
    assert not K.sqrt_uses_pair(K.SQRT_PAIR_MAX_N + 1)
    assert all(K.sqrt_uses_pair(n) for n in (64, 128, 768))
    assert not K.sqrt_uses_pair(655_360)
    assert K.add_uses_group(1) and K.add_uses_group(K.ADD_GROUP_MAX_N)
    assert not K.add_uses_group(K.ADD_GROUP_MAX_N + 1)
    assert all(K.add_uses_group(n) for n in (32, 512))
    assert not any(K.add_uses_group(n) for n in (32_768, 262_144, 1_835_520))


def test_entries_and_plain_versions_on_the_cpu():
    """Each new C entry belongs to its kernel's source (bound like the
    others), and on the CPU the wrappers run the plain versions whichever
    entry is asked for."""
    assert K.ENTRIES["g1_sqrt"] == ("g1_sqrt", "g1_sqrt_pair")
    assert {"g1_add_group", "g1_add_scan_group"} <= set(K.ENTRIES["g1_add"])
    assert set(K.LAUNCHES_BY_ENTRY) == {e for es in K.ENTRIES.values()
                                        for e in es}
    assert K._ARGTYPES["g1_sqrt_pair"] == K._ARGTYPES["g1_sqrt"]
    assert K._ARGTYPES["g1_add_group"] == K._ARGTYPES["g1_add"]
    assert K._ARGTYPES["g1_add_scan_group"] == K._ARGTYPES["g1_add_scan"]
    before = dict(K.LAUNCHES)
    pxp = torch.from_numpy(np.random.default_rng(33).integers(
        0, 2**31, size=(12, 5), dtype=np.int32))
    pxp[-1] &= 0x0FFFFFFF                # residues below q
    p, q = _special_pairs(5)
    key = torch.zeros(5, dtype=torch.int64)
    for flag in (None, True, False):
        assert torch.equal(K.g1_sqrt(pxp, pair=flag), K.g1_sqrt_plain(pxp))
        assert all(torch.equal(a, b) for a, b in zip(
            K.g1_add(p, q, group=flag), K.g1_add_plain(p, q)))
        assert all(torch.equal(a, b) for a, b in zip(
            K.g1_add_scan(p, key, 1, group=flag),
            K.g1_add_scan_plain(p, key, 1)))
    assert K.LAUNCHES == before          # plain versions launch nothing
