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
- `csrc/g1_horner.cuh`'s chain (`cc::horner` over the window sums read in
  place, then `cc::store_canonical`), the kernel's, built with g++ over
  `fq_cc.cuh`'s C twin: array-equal to the plain version;
- `g1_horner_plain` array-equal to the composition it replaces (320
  `g1_add` calls, then `_leave_montgomery`), and a grouped MSM dispatch on
  the CPU, slot and table mode, whose decoded points equal the host MSM's.

Tolerance: exact (canonical residues)."""

import ctypes
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
from curdleproofs_tpu_torch.ops.limbs import FQ_LIMBS, ints_to_limbs

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

// the kernel's chain for each relation in turn: ws [3, 24, n_rel, 64],
// out [3, 24, n_rel]
extern "C" void cc_horner(const uint32_t* ws, long n_rel, uint32_t* out) {
  const long c = 24 * n_rel * cc::HORNER_WINDOWS;
  for (long r = 0; r < n_rel; ++r) {
    cc::DirectWindows win{ws, ws + c, ws + 2 * c, n_rel, r};
    cc::store_canonical(out, n_rel, r, cc::horner(win));
  }
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
    h.cc_horner.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    return h


def test_kernel_chain_equals_plain(lib, wsums, plain):
    out = np.zeros((3, FQ_LIMBS, N_REL), np.uint32)
    lib.cc_horner(wsums.ctypes.data_as(ctypes.c_void_p), N_REL,
                  out.ctypes.data_as(ctypes.c_void_p))
    assert np.array_equal(out, plain)


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
