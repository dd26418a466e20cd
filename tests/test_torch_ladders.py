"""The ladders of the all-device backend (`ops/msm.py`, the `g1_ladder`
kernel's plain version) against the JAX package's jitted ladders and the
host model, the kernel's lane loop through the C twin of its field core,
and the all-device backend on the CPU against the host backend.

- `batch_mul_plain`, `batch_mul_each_plain` and `fold_plain` at n = 8
  against `curdleproofs_tpu.ops.msm.batch_mul_jit`, `batch_mul_each_jit`
  and `fold_jit` on the same [24, 8] limbs: array equality.  The points
  hold infinity (0 : 1 : 0) and projective representatives whose x, y or z
  is near q in Montgomery form (q - 6, q - 7, q - 8), so each doubling's
  outputs must be reduced below q before the complete add takes them; the
  per-point scalars are 0, 1, 2, r - 1 and random ones.
- The same outputs against host `G1.mul` (affine equality).
- `csrc/g1_ladder.cuh`'s `cc::glv_lane`, the kernel's lane (the GLV split
  into two halves of signed 4-bit windows, a chain a half joined by one
  add, as the kernel's two threads a point), built with g++ over
  `fq_cc.cuh`'s C twin: each entry equal to its plain version after
  affine normalization (the chain adds in another order) and to the
  host's multiples; the uniform entries (which skip the windows above the
  top digit and the adds of zero digits) equal, lane by lane, to the
  per-point entry on each of those scalars; 0, 1, 2, r - 1, lambda,
  r - lambda, multiples of lambda and scalars whose halves are 0 or
  negative against the host; `glv_split` and the kernel's Booth digits
  of its halves round-tripping k1 + k2 lambda = k (mod r), through the
  native split and the Python one; the header's beta
  equal to `host.glv`'s; `cc::g1_double` against `g1_double64`, and that
  against the port's `g1_double`.
- `DeviceBackend(device="cpu")` against `HostBackend` for `batch_mul`,
  `batch_mul_each` and `fold_points` at n = 8 (the ladders), and below
  `MIN_DEVICE_SIZE` (the host).

Tolerance: exact (canonical residues), the GLV lanes after affine
normalization."""

import ctypes
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import g1_ops as jg
from curdleproofs_tpu.ops import msm as jmsm
from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import Q, R
from curdleproofs_tpu_torch.host import glv
from curdleproofs_tpu_torch.host.g1 import G1
from curdleproofs_tpu_torch.host.glv import BETA, LAMBDA, decompose
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import msm
from curdleproofs_tpu_torch.ops.backend import DeviceBackend
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops.g1_ops import (
    PointsXYZ, g1_double, g1_double64, points_from_device,
)
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops.kernels import CSRC
from curdleproofs_tpu_torch.ops.limbs import FQ_LIMBS, ints_to_bits, ints_to_limbs

torch.set_num_threads(1)

N = 8
FUNCS = ("batch_mul", "batch_mul_each", "fold")


def _reps(points, rng: np.random.Generator) -> np.ndarray:
    """[3, 24, N] uint32 Montgomery limbs of projective representatives:
    (l x : l y : l), l random, for lanes 0-4; lanes 5, 6 and 7 take the l
    that makes x, y or z equal q - 6, q - 7 or q - 8 in Montgomery form;
    infinity is (0 : 1 : 0)."""
    cols = []
    for j, p in enumerate(points):
        if p.is_infinity():
            cols.append([0, FQ.to_mont(1), 0])
            continue
        c = [*p.to_affine(), 1]
        if j >= 5:
            want = FQ.from_mont(Q - 1 - j)      # its Montgomery form: q-1-j
            lam = want * pow(c[j - 5], -1, Q) % Q
        else:
            lam = int(rng.integers(1, 2**62))
        cols.append([FQ.to_mont(v * lam % Q) for v in c])
    return np.stack([ints_to_limbs(list(col), FQ_LIMBS).T
                     for col in zip(*cols)])


@pytest.fixture(scope="module")
def case():
    rng = StdRng.seed_from_u64(21)
    r = np.random.default_rng(21)
    pts = [rng.rand_g1() for _ in range(4)] + [G1.infinity()] \
        + [rng.rand_g1() for _ in range(3)]
    ks = [0, 1, 2, R - 1] + [rng.rand_fr() for _ in range(N - 4)]
    k, gamma = rng.rand_fr(), rng.rand_fr()
    # the fold's last lane sums to infinity: -(gamma P) + gamma P
    left = [rng.rand_g1() for _ in range(N - 1)] + [pts[-1].mul(gamma).neg()]
    limbs = {"right": _reps(pts, r), "left": _reps(left, r)}
    bits = {"batch_mul": ints_to_bits([k], msm.NBITS)[0],
            "batch_mul_each": ints_to_bits(ks, msm.NBITS),
            "fold": ints_to_bits([gamma], msm.NBITS)[0]}
    want = {"batch_mul": [p.mul(k) for p in pts],
            "batch_mul_each": [p.mul(s) for p, s in zip(pts, ks)],
            "fold": [lp.add(p.mul(gamma)) for lp, p in zip(left, pts)]}
    tp = {s: PointsXYZ(*(torch.from_numpy(c.view(np.int32)) for c in a))
          for s, a in limbs.items()}
    plain = {"batch_mul": msm.batch_mul_plain(tp["right"], bits["batch_mul"]),
             "batch_mul_each": msm.batch_mul_each_plain(
                 tp["right"], bits["batch_mul_each"]),
             "fold": msm.fold_plain(tp["left"], tp["right"], bits["fold"])}
    return dict(pts=pts, left=left, ks=ks, k=k, gamma=gamma, limbs=limbs,
                bits=bits, want=want, tp=tp, plain=plain)


@pytest.mark.parametrize("func", FUNCS)
def test_plain_ladders_equal_the_jax_ladders(case, func):
    jp = {s: jg.PointsXYZ(*(jnp.asarray(c) for c in a))
          for s, a in case["limbs"].items()}
    bits = jnp.asarray(case["bits"][func])
    got = {"batch_mul": lambda: jmsm.batch_mul_jit(jp["right"], bits),
           "batch_mul_each": lambda: jmsm.batch_mul_each_jit(jp["right"],
                                                             bits),
           "fold": lambda: jmsm.fold_jit(jp["left"], jp["right"], bits)}[func]()
    for t, j in zip(case["plain"][func], got):
        assert np.array_equal(t.numpy().view(np.uint32), np.asarray(j))


@pytest.mark.parametrize("func", FUNCS)
def test_plain_ladders_equal_host_mul(case, func):
    assert points_from_device(case["plain"][func]) == case["want"][func]


_HARNESS = r"""
#include "fq_cc.cuh"
#include "g1_ladder.cuh"

// the kernel's lanes in turn, both halves in this thread (each half's
// chain, then the join, as the kernel's two threads): p, left [3, 24, n],
// halves [2, 5] or [2, 5, n], out [3, 24, n]
extern "C" void cc_ladder(int entry, const uint32_t* p,
                          const uint32_t* halves, const uint32_t* left,
                          long n, uint32_t* out) {
  const uint32_t *x = p, *y = p + 24 * n, *z = p + 48 * n;
  const uint32_t *lx = left, *ly = left + 24 * n, *lz = left + 48 * n;
  uint32_t tab[cc::GLV_TABLE * cc::POINT_WORDS];
  for (long lane = 0; lane < n; ++lane) {
    const cc::Proj r = cc::glv_lane(entry != 1, entry == 2, x, y, z, halves,
                                    lx, ly, lz, n, lane, tab);
    cc::store16(out, n, lane, r.x);
    cc::store16(out + 24 * n, n, lane, r.y);
    cc::store16(out + 48 * n, n, lane, r.z);
  }
}

extern "C" void cc_double(const uint32_t* p, long n, uint32_t* out) {
  for (long lane = 0; lane < n; ++lane) {
    cc::Proj a{cc::load16(p, n, lane), cc::load16(p + 24 * n, n, lane),
               cc::load16(p + 48 * n, n, lane)};
    cc::Proj r = cc::g1_double(a);
    cc::store16(out, n, lane, r.x);
    cc::store16(out + 24 * n, n, lane, r.y);
    cc::store16(out + 48 * n, n, lane, r.z);
  }
}

extern "C" void cc_beta(uint32_t* out) {
  for (int i = 0; i < cc::NL; ++i) out[i] = cc::beta_limb(i);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("ladder")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libharness.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror",
                    "-Wno-unknown-pragmas", "-fno-omit-frame-pointer",
                    "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   text=True)
    h = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    h.cc_ladder.argtypes = [ctypes.c_int, p, p, p, ctypes.c_long, p]
    h.cc_double.argtypes = [p, ctypes.c_long, p]
    h.cc_beta.argtypes = [p]
    return h


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _c_ladder(lib, entry: int, case, words) -> np.ndarray:
    """The kernel's lane over the case's points for the scalar words (as
    the wrapper takes them), through `glv_split` as the wrapper packs
    them."""
    p, left = (np.ascontiguousarray(case["limbs"][s]) for s in
               ("right", "left"))
    halves = np.ascontiguousarray(
        K.glv_split(torch.from_numpy(np.asarray(words))).numpy()
        .view(np.uint32))
    out = np.zeros_like(p)
    lib.cc_ladder(entry, _ptr(p), _ptr(halves), _ptr(left), N, _ptr(out))
    return out


def _points(limbs: np.ndarray) -> list[G1]:
    return points_from_device(PointsXYZ(*(torch.from_numpy(c.view(np.int32))
                                          for c in limbs)))


def _words(bits, per_point=False) -> np.ndarray:
    return msm.scalar_words(bits, "cpu", per_point).numpy()


@pytest.mark.parametrize("func", FUNCS)
def test_kernel_lane_equals_plain(lib, case, func):
    """Each entry's lane equals its plain version after affine
    normalization (the GLV chain adds in another order, so the projective
    representatives differ) and the host's multiples."""
    entry = FUNCS.index(func)
    want = points_from_device(case["plain"][func])
    assert want == case["want"][func]
    got = _c_ladder(lib, entry, case, _words(case["bits"][func], entry == 1))
    assert _points(got) == want


def test_uniform_lane_skips_give_the_per_point_words(lib, case):
    """The uniform entries skip the windows above the top nonzero digit and
    the adds of zero digits: for each per-point scalar (0, 1, 2, r - 1,
    random), its lane's words equal the per-point entry's."""
    each = _c_ladder(lib, 1, case, _words(case["bits"]["batch_mul_each"],
                                          True))
    for j, s in enumerate(case["ks"]):
        got = _c_ladder(lib, 0, case, _words(ints_to_bits([s], msm.NBITS)[0]))
        assert np.array_equal(got[:, :, j], each[:, :, j])


def _special_scalars() -> list[int]:
    """0, 1, 2, r - 1, lambda and r - lambda (one half 0, the other +-1),
    scalars whose k1 or k2 is 0 or negative, both halves negative, and a
    random one."""
    rnd = random.Random(23)
    ks = [0, 1, 2, R - 1, LAMBDA, R - LAMBDA, 5 * LAMBDA % R,
          (R - 7) * LAMBDA % R]
    want = {(True, True), (True, False), (False, True)}   # k1 < 0, k2 < 0
    while want:
        k = rnd.randrange(R)
        k1, k2 = decompose(k)
        if (k1 < 0, k2 < 0) in want:
            want.discard((k1 < 0, k2 < 0))
            ks.append(k)
    return ks + [rnd.randrange(R)]


@pytest.mark.parametrize("func", FUNCS)
def test_kernel_lane_special_scalars(lib, case, func):
    """Each entry's lane on the special scalars against the host's
    multiples (affine equality): one scalar for all lanes (points with
    infinity and near-q representatives), one a lane, and the fold."""
    pts, left = case["pts"], case["left"]
    ks = _special_scalars()
    if func == "batch_mul_each":
        for at in range(0, len(ks), N):
            each = (ks[at:at + N] * N)[:N]
            got = _c_ladder(lib, 1, case,
                            _words(ints_to_bits(each, msm.NBITS), True))
            assert _points(got) == [p.mul(s) for p, s in zip(pts, each)]
        return
    for k in ks:
        got = _points(_c_ladder(lib, FUNCS.index(func), case,
                                _words(ints_to_bits([k], msm.NBITS)[0])))
        if func == "batch_mul":
            assert got == [p.mul(k) for p in pts]
        else:
            assert got == [a.add(p.mul(k)) for a, p in zip(left, pts)]


def _glv_digits(halves: torch.Tensor) -> np.ndarray:
    """The kernel's digits of `glv_split`'s halves ([2, 5] or [2, 5, N]),
    read on the host as `cc::Digits` reads them: [2, N, 33] int8, digit
    j = b(4j-1) + b(4j) + 2 b(4j+1) + 4 b(4j+2) - 8 b(4j+3) of the
    magnitude (b(-1) = 0; Booth's rule, in [-8, 8]), negated for a
    negative half, so k_h = sum_j d_j 16^j."""
    w = halves.numpy().view(np.uint32).reshape(2, K.GLV_HALF_WORDS, -1)
    neg = (w[:, -1] >> 31).astype(bool)                    # [2, N]
    mag = w.copy()
    mag[:, -1] &= 0x7FFFFFFF
    le = np.ascontiguousarray(mag.transpose(0, 2, 1)).view(np.uint8)
    bits = np.unpackbits(le, axis=2, bitorder="little").astype(np.int8)
    b = np.zeros(bits.shape[:2] + (4 * K.GLV_WINDOWS + 1,), np.int8)
    b[:, :, 1:] = bits[:, :, :4 * K.GLV_WINDOWS]           # b[i + 1] = b(i)
    d = (b[:, :, 0:-1:4] + b[:, :, 1::4] + 2 * b[:, :, 2::4]
         + 4 * b[:, :, 3::4] - 8 * b[:, :, 4::4])
    return np.where(neg[:, :, None], -d, d).astype(np.int8)


@pytest.mark.parametrize("native", [True, False])
def test_glv_digits_round_trip(native, monkeypatch):
    """`glv_split` (the native split, or `host.glv.decompose` a scalar) and
    the kernel's Booth digits of its halves: 33 digits in [-8, 8] a half,
    each half's digits summing to its signed magnitude, k1 + k2 * lambda =
    k (mod r), |k_h| < 2^129, the one-scalar form equal to its column of
    the per-point form; a scalar not below r is refused."""
    if not native:
        monkeypatch.setattr(glv, "decompose_batch_raw", lambda ks, n: None)
    ks = _special_scalars() + [random.Random(5).randrange(R)
                               for _ in range(40)]
    words = torch.from_numpy(_words(ints_to_bits(ks, msm.NBITS), True))
    halves = K.glv_split(words)
    assert halves.shape == (2, K.GLV_HALF_WORDS, len(ks))
    assert halves.dtype == torch.int32
    w = halves.numpy().view(np.uint32)
    digits = _glv_digits(halves)
    assert digits.shape == (2, len(ks), K.GLV_WINDOWS)
    assert np.abs(digits).max() <= 8
    for i, k in enumerate(ks):
        signed = []
        for h in range(2):
            mag = sum(int(v) << (32 * j) for j, v in enumerate(w[h, :, i]))
            mag, neg = mag & ((1 << 159) - 1), mag >> 159
            assert mag < 1 << 129
            signed.append(-mag if neg else mag)
            assert sum(int(d) << (4 * j)
                       for j, d in enumerate(digits[h, i])) == signed[-1]
        assert (signed[0] + signed[1] * LAMBDA - k) % R == 0
        one = K.glv_split(words[:, i].contiguous())
        assert one.shape == (2, K.GLV_HALF_WORDS)
        assert np.array_equal(one.numpy(), halves.numpy()[:, :, i])
    with pytest.raises(ValueError, match="below r"):
        K.glv_split(torch.from_numpy(_words(ints_to_bits([R], msm.NBITS)[0])))


def test_beta_constant_is_the_host_glv_beta(lib):
    out = np.zeros(12, np.uint32)
    lib.cc_beta(_ptr(out))
    assert sum(int(v) << (32 * i) for i, v in enumerate(out)) == \
        FQ.to_mont(BETA)


def test_doubling_core_and_plain_equal_g1_double(lib, case):
    p = np.ascontiguousarray(case["limbs"]["right"])
    out = np.zeros_like(p)
    lib.cc_double(_ptr(p), N, _ptr(out))
    tp = case["tp"]["right"]
    plain = g1_double64(PointsXYZ(*(c.long() for c in tp)))
    for j, (a, b) in enumerate(zip(plain, g1_double(tp))):
        assert torch.equal(a, b.long())
        assert np.array_equal(out[j], a.numpy().astype(np.uint32))


def test_device_backend_on_cpu_matches_host(case):
    b, h = DeviceBackend(device="cpu"), HostBackend()
    pts, left, k = case["pts"], case["left"], case["k"]
    assert b.batch_mul(pts, k) == h.batch_mul(pts, k)
    assert b.batch_mul_each(pts, case["ks"]) == h.batch_mul_each(pts,
                                                                 case["ks"])
    assert b.fold_points(left, pts, k) == h.fold_points(left, pts, k)
    # below MIN_DEVICE_SIZE the host serves
    few = pts[:b.MIN_DEVICE_SIZE - 1]
    assert b.batch_mul(few, k) == h.batch_mul(few, k)


def test_device_backend_outputs_leave_as_affine_points(case):
    """The all-device backend's ladder outputs leave the device through
    `points_from_device` as affine points (z = 1, or infinity), so no
    projective representative of the kernel's reaches a transcript."""
    b = DeviceBackend(device="cpu")
    pts, left, k = case["pts"], case["left"], case["k"]
    for out in (b.batch_mul(pts, k), b.batch_mul_each(pts, case["ks"]),
                b.fold_points(left, pts, k)):
        assert all(p.is_infinity() or p.z == 1 for p in out)
