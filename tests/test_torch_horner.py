"""The grouped MSM's Horner step (`ops/kernels.py::g1_horner` and its plain
version, `csrc/g1_horner.cuh`) on the CPU, at n_rel = 8 relations of the
64 window sums:

- `g1_horner_plain` against the JAX package's `horner_device(ws,
  pallas=False)` on the same [24, 8, 64] Montgomery window sums (numpy
  seed 13): projective representatives (l x : l y : l) of points from a
  pool, with sums at infinity (0 : 1 : 0), the all-zero rows of the
  reference's padding, and representatives whose x, y or z is near q in
  Montgomery form (q - 1 - j); a relation of infinities alone, and one
  whose sum is infinity.  Array equality;
- `csrc/g1_horner.cuh`'s group schedule (`cc::horner_group`: 256
  complete doublings and 64 complete adds, each two levels of independent
  products, then `cc::store_group`), built with g++ over `fq_cc.cuh`'s C
  twin, its exchange `cc::LoopExchange<G>` running the G lanes' roles in
  turn in one thread: at the kernel's G (`HORNER_G` of `g1_horner.cu`)
  the plain version's points after affine normalization and its words
  (on the curve the complete doubling gives the complete add's P + P
  coordinate for coordinate); at G = 1, 2 and 4 the same words as at the
  kernel's G; the doubling (`cc::g1_double` and its group schedule at
  G = 4 and 8) against the plain complete add of each point to itself;
- `g1_horner_plain` array-equal to the composition it replaces (320
  `g1_add` calls, then `_leave_montgomery`), and a grouped MSM dispatch on
  the CPU, slot and table mode, whose decoded points equal the host MSM's;
- `kernel_probe.HornerVariant`, the G trial's build of the source with
  the other HORNER_G, under a stand-in compiler.

Tolerance: exact (canonical residues)."""

import ctypes
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import msm_grouped as jg
from curdleproofs_tpu.ops.g1_ops import PointsXYZ as JPoints
from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import Q
from curdleproofs_tpu_torch.host.g1 import G1
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops import msm_grouped as mg
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ, g1_add, g1_infinity
from curdleproofs_tpu_torch.ops.limbs import (
    FQ_LIMBS, ints_to_limbs, limbs_to_ints,
)
from curdleproofs_tpu_torch.tools import kernel_probe as kp

torch.set_num_threads(1)

N_REL, W = 8, K.HORNER_WINDOWS


def _rep(p, lam: int) -> list[int]:
    """Montgomery (l x : l y : l) of host point p; infinity (0 : 1 : 0)."""
    if p.is_infinity():
        return [0, FQ.to_mont(1), 0]
    return [FQ.to_mont(v * lam % Q) for v in (*p.to_affine(), 1)]


@pytest.fixture(scope="module")
def wsums() -> np.ndarray:
    """[3, 24, 8, 64] uint32 Montgomery window sums (see the docstring)."""
    rng = StdRng.seed_from_u64(13)
    pool = [rng.rand_g1() for _ in range(16)]
    r = np.random.default_rng(13)
    pts = [[pool[int(i)] for i in r.integers(len(pool), size=W)]
           for _ in range(N_REL)]
    pts[0] = [G1.infinity()] * W                   # infinities alone
    for w in range(0, W, 5):
        pts[3][w] = G1.infinity()
    # relation 5 sums to infinity: window 0 is minus the rest
    rest = G1.infinity()
    for w in range(1, W):
        rest = rest.add(pts[5][w].mul(16 ** w))
    pts[5][0] = rest.neg()
    cols = []
    for rel in range(N_REL):
        for w, p in enumerate(pts[rel]):
            if rel == 4 and w % 7 == 1:
                cols.append([0, 0, 0])             # the padding's rows
            elif rel >= 6 and w % 3 == 0:          # x, y or z near q
                c = [*p.to_affine(), 1]
                lam = FQ.from_mont(Q - 1 - w % 50) \
                    * pow(c[(w // 3) % 3], -1, Q) % Q
                cols.append(_rep(p, lam))
            else:
                cols.append(_rep(p, int(r.integers(1, 2**62))))
    arr = np.stack([ints_to_limbs([c[k] for c in cols], FQ_LIMBS).T
                    for k in range(3)])                  # [3, 24, 512]
    return np.ascontiguousarray(arr.reshape(3, FQ_LIMBS, N_REL, W)
                                .astype(np.uint32))


def _torch(ws: np.ndarray) -> PointsXYZ:
    return PointsXYZ(*(torch.from_numpy(c.view(np.int32)) for c in ws))


@pytest.fixture(scope="module")
def plain(wsums) -> np.ndarray:
    return K.g1_horner_plain(*_torch(wsums)).numpy().view(np.uint32)


def test_plain_equals_the_jax_horner(wsums, plain):
    got = jg.horner_device(JPoints(*(jnp.asarray(c) for c in wsums)),
                           pallas=False)
    assert np.array_equal(plain, np.asarray(got))


def test_plain_cases(plain):
    """Relation 0 (infinities alone) and relation 5 (a sum of infinity)
    come out at z = 0; the others are finite."""
    assert plain.shape == (3, FQ_LIMBS, N_REL)
    z_zero = ~plain[2].any(axis=0)
    assert z_zero[0] and z_zero[5]
    assert not z_zero[[1, 2, 3, 6, 7]].any()


_HARNESS = r"""
#include "fq_cc.cuh"
#include "g1_horner.cuh"

// the group schedule at G lanes, every role in turn in this thread, for
// each relation: ws [3, 24, n_rel, 64], out [3, 24, n_rel]
template <int G>
void horner(const uint32_t* ws, long n_rel, uint32_t* out) {
  const long c = 24 * n_rel * cc::HORNER_WINDOWS;
  for (long r = 0; r < n_rel; ++r) {
    cc::DirectWindows win{ws, ws + c, ws + 2 * c, n_rel, r};
    cc::LoopExchange<G> ex;
    cc::store_group(ex, out, n_rel, r, true, cc::horner_group(ex, win));
  }
}

extern "C" int cc_horner(const uint32_t* ws, long n_rel, uint32_t* out,
                         int g) {
  switch (g) {
    case 1: horner<1>(ws, n_rel, out); return 0;
    case 2: horner<2>(ws, n_rel, out); return 0;
    case 4: horner<4>(ws, n_rel, out); return 0;
    case 8: horner<8>(ws, n_rel, out); return 0;
  }
  return 1;
}

template <int G>
cc::Proj dbl(const cc::Proj& p) {
  cc::LoopExchange<G> ex;
  return cc::double_group(ex, p);
}

// 2 P for Montgomery points [3, 24, n] -> [3, 24, n]: cc::g1_double in one
// thread (g = 0) or the group schedule at g lanes
extern "C" int cc_double(const uint32_t* pts, long n, uint32_t* out, int g) {
  for (long i = 0; i < n; ++i) {
    const cc::Proj p{cc::load16(pts, n, i), cc::load16(pts + 24 * n, n, i),
                     cc::load16(pts + 48 * n, n, i)};
    cc::Proj d;
    switch (g) {
      case 0: d = cc::g1_double(p); break;
      case 4: d = dbl<4>(p); break;
      case 8: d = dbl<8>(p); break;
      default: return 1;
    }
    cc::store16(out, n, i, d.x);
    cc::store16(out + 24 * n, n, i, d.y);
    cc::store16(out + 48 * n, n, i, d.z);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("horner")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libharness.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror",
                    "-Wno-unknown-pragmas", "-fno-omit-frame-pointer",
                    "-shared", "-fPIC", "-I", str(K.CSRC), "-o", str(so),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   text=True)
    h = ctypes.CDLL(str(so))
    for fn in (h.cc_horner, h.cc_double):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
    return h


def _group_run(lib, wsums, g: int) -> np.ndarray:
    out = np.zeros((3, FQ_LIMBS, N_REL), np.uint32)
    assert lib.cc_horner(wsums.ctypes.data_as(ctypes.c_void_p), N_REL,
                         out.ctypes.data_as(ctypes.c_void_p), g) == 0
    return out


def _coords(a: np.ndarray) -> list[list[int]]:
    """[3, 24, n] 16-bit limb rows -> each coordinate's n integers."""
    return [limbs_to_ints(c.T) for c in a]


def _assert_same_points(got: np.ndarray, want: np.ndarray) -> None:
    """Each column of `got` is the point of `want`'s: (0, 0, 0) where
    `want` has it, infinity (0 : y : 0), y != 0, where `want` has one, else
    equal after affine normalization (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1 mod q,
    Montgomery or canonical alike)."""
    (gx, gy, gz), (wx, wy, wz) = _coords(got), _coords(want)
    for i in range(got.shape[2]):
        if wx[i] == wy[i] == wz[i] == 0:
            assert gx[i] == gy[i] == gz[i] == 0, i
        elif wz[i] == 0:
            assert wx[i] == 0 and wy[i] != 0, i
            assert gx[i] == gz[i] == 0 and gy[i] != 0, i
        else:
            assert gz[i] != 0, i
            assert gx[i] * wz[i] % Q == wx[i] * gz[i] % Q, i
            assert gy[i] * wz[i] % Q == wy[i] * gz[i] % Q, i


def test_kernel_chain_equals_plain(lib, wsums, plain):
    """The kernel's schedule (the group at the kernel's G, every role in
    turn) against the plain version: the same points after affine
    normalization, with (0 : 1 : 0) and (0, 0, 0) where the plain version
    has them (relations 0 and 4), and the plain version's words throughout:
    on the curve the complete doubling gives the complete add's P + P
    coordinate for coordinate (`test_doubling_schedule_equals_self_add`)."""
    out = _group_run(lib, wsums, kp.horner_g())
    _assert_same_points(out, plain)
    (px, py, pz) = _coords(plain)
    assert (px[0], py[0], pz[0]) == (0, 1, 0) and px[4] == py[4] == pz[4] == 0
    for rel in (0, 4):
        assert np.array_equal(out[:, :, rel], plain[:, :, rel])
    assert np.array_equal(out, plain)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_group_sizes_agree(lib, wsums, g):
    """The group schedule at g lanes equals it at the kernel's G word for
    word (the same field operations, in other lanes), hence after affine
    normalization too: g = 4 is the G trial's other size, g = 1 the
    schedule in one thread."""
    ref = _group_run(lib, wsums, kp.horner_g())
    got = _group_run(lib, wsums, g)
    _assert_same_points(got, ref)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("g", [0, 4, 8])
def test_doubling_schedule_equals_self_add(lib, wsums, g):
    """The complete doubling (`cc::g1_double`, g = 0, or its group schedule
    at g lanes) of the fixture's 512 window sums (infinities, the padding's
    zero rows, coordinates near q) against the plain complete add of each
    point to itself: the same points after affine normalization, the zero
    rows (0, 0, 0), and the same words.  For (X : Y : Z) on y^2 = x^3 + b
    both give X3 = 2 X Y (Y^2 - 9 b Z^2), Y3 = Y^4 + 18 b Y^2 Z^2 -
    27 b^2 Z^4, Z3 = 8 Y^3 Z (the add's Y3 and Z3 reduce to these with
    X^3 Z = Y^2 Z^2 - b Z^4), and every output is canonical."""
    pts = np.ascontiguousarray(wsums.reshape(3, FQ_LIMBS, N_REL * W))
    n = pts.shape[2]

    def run(g_):
        out = np.zeros_like(pts)
        assert lib.cc_double(pts.ctypes.data_as(ctypes.c_void_p), n,
                             out.ctypes.data_as(ctypes.c_void_p), g_) == 0
        return out

    got = run(g)
    p = _torch(pts)
    want = np.stack([c.numpy().view(np.uint32)
                     for c in K.g1_add_plain(p, p)])
    _assert_same_points(got, want)
    zero = ~pts.any(axis=(0, 1))
    assert zero.any() and not got[:, :, zero].any()
    assert np.array_equal(got, want)
    if g:
        assert np.array_equal(got, run(0))


def test_plain_equals_the_launch_chain_it_replaces(wsums, plain):
    """The port's earlier Horner: 64 x (4 self-adds + 1 add) through the
    `g1_add` wrapper, then `_leave_montgomery`'s one product."""
    ws = _torch(wsums)
    acc = g1_infinity((N_REL,), "cpu")
    for w in range(W):
        for _ in range(4):
            acc = g1_add(acc, acc)
        acc = g1_add(acc, PointsXYZ(*(c[:, :, W - 1 - w] for c in ws)))
    old = md._leave_montgomery(acc).numpy().view(np.uint32)
    assert np.array_equal(old, plain)
    assert np.array_equal(mg.horner_device(ws).numpy().view(np.uint32), plain)


@pytest.mark.parametrize("table", [False, True])
def test_grouped_dispatch_points(table):
    """One grouped dispatch on the CPU (slot mode with the mixed-add fold,
    or table mode) decodes to the host MSM's points."""
    rng = StdRng.seed_from_u64(17)
    pool = [rng.rand_g1() for _ in range(24)]
    r = np.random.default_rng(17)
    rels = [([int(c) for c in r.choice(len(pool), size=w, replace=False)],
             [rng.rand_fr() for _ in range(w)]) for w in (1, 5, 9, 16)]
    bases = md.DeviceBases(pool, "cpu")
    got = (mg.grouped_msm_table(mg.DeviceBasesTable(bases), rels) if table
           else mg.grouped_msm(bases, rels))
    host = HostBackend()
    assert got == [host.msm([pool[c] for c in cs], ss) for cs, ss in rels]


def _stand_in_nvcc(tmp_path, monkeypatch, rc: int) -> pathlib.Path:
    """A compiler under CUDA_HOME that records its arguments and exits
    with `rc`."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" > "{home}/args"\n'
                    f'echo "ptxas report"\nexit {rc}\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    return home


def test_horner_variant_source(tmp_path, monkeypatch):
    """`kernel_probe.HornerVariant` (`chip_smoke.py`'s G trial) writes
    g1_horner.cu with the other HORNER_G of (4, 8) and no other change,
    beside the headers it includes, and runs nvcc on it with the kernel
    store's flags (a stand-in compiler here)."""
    from curdleproofs_tpu_torch.ops import aot

    home = _stand_in_nvcc(tmp_path, monkeypatch, 0)
    v = kp.HornerVariant(tmp_path / "v")
    assert v._proc.wait() == 0
    assert {v.g, v.shipped_g} == set(kp.HORNER_G_TRIAL)
    assert v.shipped_g == kp.horner_g()
    src = (K.CSRC / "g1_horner.cu").read_text()
    line = "constexpr int HORNER_G = {};"
    assert (tmp_path / "v" / "g1_horner.cu").read_text() == src.replace(
        line.format(v.shipped_g), line.format(v.g))
    for h in ("fq_cc.cuh", "g1_horner.cuh"):
        assert (tmp_path / "v" / h).read_bytes() == (K.CSRC / h).read_bytes()
    args = (home / "args").read_text().split()
    assert args[:len(aot.NVCC_FLAGS)] == aot.NVCC_FLAGS
    assert args[-1] == str(tmp_path / "v" / "g1_horner.cu")


def test_horner_variant_build_failure_raises(tmp_path, monkeypatch):
    """A variant that does not build raises with the compiler's report."""
    _stand_in_nvcc(tmp_path, monkeypatch, 1)
    with pytest.raises(RuntimeError, match="ptxas report"):
        kp.HornerVariant(tmp_path / "v").launcher()
