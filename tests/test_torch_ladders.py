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
- `csrc/g1_ladder.cuh`'s `cc::ladder_lane`, the kernel's lane, built with
  g++ over `fq_cc.cuh`'s C twin: each entry array-equal to its plain
  version, and the uniform entry (which skips the steps above the top bit
  and the adds of zero bits) equal, lane by lane, to the per-point ladder
  for each of those scalars; `cc::g1_double` against `g1_double64`, and
  that against the port's `g1_double`.
- `DeviceBackend(device="cpu")` against `HostBackend` for `batch_mul`,
  `batch_mul_each` and `fold_points` at n = 8 (the ladders), and below
  `MIN_DEVICE_SIZE` (the host).

Tolerance: exact everywhere (canonical residues)."""

import ctypes
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
from curdleproofs_tpu_torch.host.g1 import G1
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import msm
from curdleproofs_tpu_torch.ops.backend import DeviceBackend
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops.g1_ops import (
    PointsXYZ, g1_double, g1_double64, points_from_device,
)
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

// the kernel's lanes in turn: p, left [3, 24, n], out [3, 24, n]
extern "C" void cc_ladder(int entry, const uint32_t* p, const uint32_t* words,
                          const uint32_t* left, long n, uint32_t* out) {
  const uint32_t *x = p, *y = p + 24 * n, *z = p + 48 * n;
  const uint32_t *lx = left, *ly = left + 24 * n, *lz = left + 48 * n;
  for (long lane = 0; lane < n; ++lane) {
    cc::Proj r =
        entry == 0 ? cc::ladder_lane<true, false>(x, y, z, words, lx, ly, lz,
                                                 n, lane)
      : entry == 1 ? cc::ladder_lane<false, false>(x, y, z, words, lx, ly, lz,
                                                  n, lane)
                   : cc::ladder_lane<true, true>(x, y, z, words, lx, ly, lz,
                                                n, lane);
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
    return h


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _c_ladder(lib, entry: int, case, words: np.ndarray) -> np.ndarray:
    p, left = (np.ascontiguousarray(case["limbs"][s]) for s in
               ("right", "left"))
    w = np.ascontiguousarray(words.view(np.uint32))
    out = np.zeros_like(p)
    lib.cc_ladder(entry, _ptr(p), _ptr(w), _ptr(left), N, _ptr(out))
    return out


def _words(bits, per_point=False) -> np.ndarray:
    return msm.scalar_words(bits, "cpu", per_point).numpy()


@pytest.mark.parametrize("func", FUNCS)
def test_kernel_lane_equals_plain(lib, case, func):
    entry = FUNCS.index(func)
    got = _c_ladder(lib, entry, case, _words(case["bits"][func], entry == 1))
    for j, t in enumerate(case["plain"][func]):
        assert np.array_equal(got[j], t.numpy().view(np.uint32))


def test_uniform_lane_skips_give_the_per_point_words(lib, case):
    """The uniform entry skips the steps above the top bit and the adds of
    zero bits: for each per-point scalar (0, 1, 2, r - 1, random), its
    lane's words equal the per-point ladder's."""
    each = case["plain"]["batch_mul_each"]
    for j, s in enumerate(case["ks"]):
        got = _c_ladder(lib, 0, case,
                        _words(ints_to_bits([s], msm.NBITS)[0]))
        for c, t in zip(got, each):
            assert np.array_equal(c[:, j], t[:, j].numpy().view(np.uint32))


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
