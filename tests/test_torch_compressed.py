"""Compressed base ingest and the full-add fold in the port, against the JAX
package and the host model on the CPU.

- `g1_sqrt_plain` (the plain version of the `g1_sqrt` kernel) against
  pow(x^3 + b, (q+1)/4, q) on Python ints, on the native exporter's x;
- the port's `_ingest_compressed` against the JAX package's
  `_ingest_compressed(..., pallas=False)` and against the port's own
  uncompressed ingest, including the identity and both parities (mirrors
  tests/test_compressed_upload.py);
- `DeviceBases` built both ways, and the `CURDLEPROOFS_COMPRESS` rule;
- `g1_fold_packed_plain` (the full-add fold) against host sums, and the
  pipeline with `madd=False` against the JAX package's
  `_msm_pipeline(..., pallas=False, madd=False)` in affine form.

Tolerance: every comparison is exact (array or point equality).  Window
sums compare in affine form: the port's bucket sort is stable and the
reference's is not asked to be, so the projective representatives may
differ."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import msm_device as jmd
from curdleproofs_tpu.ops.pallas_kernels import SQRT_DIGITS as J_SQRT_DIGITS
from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import CURVE_B, Q, R
from curdleproofs_tpu_torch.host import native
from curdleproofs_tpu_torch.host.g1 import G1
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.host.serde import g1_to_bytes
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops.field import FQ, unpack_pairs
from curdleproofs_tpu_torch.ops.g1_ops import points_from_device
from curdleproofs_tpu_torch.ops.limbs import limbs_to_ints

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

rnd = random.Random(23)


@pytest.fixture(autouse=True)
def _native():
    if not native.available():
        pytest.skip("native runtime unavailable")


def _points(n, seed):
    """n random points, then the identity and a negation (both parities
    of y appear among the random ones and their negations)."""
    rng = StdRng.seed_from_u64(seed)
    pts = [rng.rand_g1() for _ in range(n)]
    return pts + [G1.infinity(), pts[1].neg()]


def _u32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32))


def _ints(rows24: torch.Tensor) -> list[int]:
    return [int(v) for v in
            limbs_to_ints(rows24.numpy().T.astype(np.uint32))]


def test_sqrt_digits_match_jax_and_pow():
    assert K.SQRT_DIGITS == tuple(J_SQRT_DIGITS)
    e = (Q + 1) // 4
    u = 0x1234567890ABCDEF ** 5 % Q
    tab = [1, u, u * u % Q, pow(u, 3, Q)]
    acc = 1
    for d in K.SQRT_DIGITS:
        acc = pow(acc, 4, Q) * tab[d] % Q
    assert acc == pow(u, e, Q)


def test_g1_sqrt_plain_matches_pow():
    pts = _points(29, seed=3)
    px, meta = native.export_mont_x(pts, 64)
    got = _ints(K.g1_sqrt_plain(_u32(px)))
    xs = [FQ.from_mont(x) for x in _ints(unpack_pairs(_u32(px)))]
    want = [FQ.to_mont(pow((x ** 3 + CURVE_B) % Q, (Q + 1) // 4, Q))
            for x in xs]
    assert got == want
    # live lanes are curve points: the candidate is y or -y
    for i, p in enumerate(pts):
        assert meta[i] & 1 == (not p.is_infinity())
        if not p.is_infinity():
            x, y = p.to_affine()
            assert xs[i] == x and FQ.from_mont(got[i]) in (y, Q - y)


def test_ingest_compressed_matches_jax_and_uncompressed():
    pts = _points(5, seed=9)
    n = 64
    px, meta = native.export_mont_x(pts, n)
    got = md._ingest_compressed(_u32(px), _u32(meta))
    jax_got = jmd._ingest_compressed(jnp.asarray(px), jnp.asarray(meta),
                                     pallas=False)
    upx, upy, uzb = native.export_mont_affine(pts, n)
    plain = md._ingest_packed_mont(_u32(upx), _u32(upy), _u32(uzb))
    for g, j, u, name in zip(got, jax_got, plain,
                             ("ext_px", "ext_py", "ext_zb")):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(j)), name
        assert torch.equal(g, u), name


@pytest.mark.parametrize("n_pad", [None, 128])
def test_device_bases_compressed_equals_uncompressed(monkeypatch, n_pad):
    pts = _points(37, seed=11)
    layouts = []
    for flag in ("1", "0"):
        monkeypatch.setenv("CURDLEPROOFS_COMPRESS", flag)
        b = md.DeviceBases(pts, "cpu", n_pad=n_pad)
        assert b.n == (n_pad or md.pad_n(len(pts)))
        layouts.append((b.ext_px, b.ext_py, b.ext_zb))
    for a, b in zip(*layouts):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        md.DeviceBases(pts, "cpu", n_pad=100)   # not a shape family


@pytest.mark.parametrize("env,device,want", [
    (None, "cpu", False), (None, "cuda", True),
    ("0", "cuda", False), ("1", "cpu", True),
])
def test_compressed_upload_rule(monkeypatch, env, device, want):
    if env is None:
        monkeypatch.delenv("CURDLEPROOFS_COMPRESS", raising=False)
    else:
        monkeypatch.setenv("CURDLEPROOFS_COMPRESS", env)
    assert md.use_compressed_upload(torch.device(device)) is want


def test_msm_over_compressed_bases_matches_host(monkeypatch):
    monkeypatch.setenv("CURDLEPROOFS_COMPRESS", "1")
    pts = _points(40, seed=13)
    ss = [rnd.randrange(R) for _ in pts]
    bases = md.DeviceBases(pts, "cpu")
    assert md.msm_device(bases, ss) == HostBackend().msm(pts, ss)


@pytest.mark.parametrize("entry,madd", [("msm", True), ("msm", False),
                                        ("stream", False)])
def test_madd_rule(monkeypatch, entry, madd):
    """`madd` picks the fold (the mixed add by default, the full add with
    madd=False), through `msm_device` and `DeviceMsmStream` alike; the MSM
    equals the host's either way."""
    used = []
    for name in ("g1_fold_madd", "g1_fold_packed"):
        monkeypatch.setattr(md, name, lambda *a, _n=name, _f=getattr(md, name):
                            (used.append(_n), _f(*a))[1])
    pts = _points(100, seed=19)
    ss = [rnd.randrange(R) for _ in pts]
    if entry == "msm":
        got = md.msm_device(pts, ss, device="cpu", madd=madd)
    else:
        stream = md.DeviceMsmStream(64, device="cpu", madd=madd)
        stream.add(pts, ss)
        got = stream.result()
    assert got == HostBackend().msm(pts, ss)
    assert set(used) == {"g1_fold_madd" if madd else "g1_fold_packed"}


def _plan(pts, ss, c=8):
    bases = md.DeviceBases(pts, "cpu")
    params = md.pick_params(bases.n, c)
    limbs = torch.from_numpy(md._scalars_to_limbs(ss, params.n)
                             .astype(np.int32))
    sp = md._slot_plan(md._signed_digits(limbs, params.n, c), n=params.n,
                       c=c, t_rows=params.t_rows, s_pad=params.s_pad)
    return bases, sp


def test_fold_packed_plain_matches_host_sums():
    """A plan with dead rows (zero digits, the identity, the sentinel) and
    duplicate bases: every slot's full-add fold equals the host sum of its
    bases, and the mixed-add fold's point."""
    pts = _points(60, seed=17)
    pts[7] = pts[8]                      # duplicate base
    ss = [rnd.randrange(R) for _ in pts]
    ss[3] = 0                            # dead digits in every window
    bases, sp = _plan(pts, ss)
    ext = (bases.ext_px, bases.ext_py, bases.ext_zb, sp.plan)
    full = points_from_device(K.g1_fold_packed_plain(*ext))
    madd = points_from_device(K.g1_fold_madd_plain(*ext))
    assert full == madd
    ext_host = pts + [G1.infinity()] * (bases.n - len(pts))
    ext_host = ext_host + [p.neg() for p in ext_host] + [G1.infinity()]
    plan = sp.plan.numpy()
    for s in range(0, plan.shape[1], 97):
        want = G1.infinity()
        for e in plan[:, s]:
            want = want.add(ext_host[e])
        assert full[s] == want


def test_pipeline_full_add_matches_jax():
    n = 40
    rng = StdRng.seed_from_u64(31 + n)
    pts = [rng.rand_g1() for _ in range(n)]
    ss = [rnd.randrange(R) for _ in range(n)]
    ss[0], pts[2] = 0, G1.infinity()
    jb = jmd.DeviceBases(pts)
    params = md.pick_params(n, 8)
    limbs = md._scalars_to_limbs(ss, params.n)
    want = np.asarray(jmd._msm_pipeline(
        jb.ext_px, jb.ext_py, jb.ext_zb, jnp.asarray(limbs), n=params.n,
        c=8, t_rows=params.t_rows, s_pad=params.s_pad, pallas=False,
        madd=False))
    tb = md.DeviceBases(pts, "cpu")
    got = md._msm_pipeline(tb, limbs, params, madd=False).numpy()
    assert [g1_to_bytes(p) for p in md._window_sums_to_host(got)] == [
        g1_to_bytes(p) for p in md._window_sums_to_host(want)]
    assert md._horner_windows(md._window_sums_to_host(got), 8) == \
        HostBackend().msm(pts, ss)
