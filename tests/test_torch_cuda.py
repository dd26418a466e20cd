"""The port's CUDA kernels on the card: each against its plain version
(array equality) and the host model, at widths that are not multiples of a
block (the ragged tail is masked).  Mirrors tests/test_tpu_kernels.py.

These need a CUDA device and skip without one; the file imports neither jax
nor the JAX package, so on the machine with the card it runs as
    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import Q, R
from curdleproofs_tpu_torch.host import native
from curdleproofs_tpu_torch.host.g1 import G1
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import kernels
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops.g1_ops import (
    PointsXYZ, points_from_device, points_to_device,
)
from curdleproofs_tpu_torch.ops.limbs import (
    FQ_LIMBS, ints_to_limbs, limbs_to_ints,
)

pytestmark = pytest.mark.cuda

rnd = random.Random(99)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pairs(n):
    rng = StdRng.seed_from_u64(2)
    ps = [rng.rand_g1() for _ in range(n)]
    qs = [rng.rand_g1() for _ in range(n - 3)] + [ps[-3], ps[-2].neg(),
                                                  G1.infinity()]
    return ps, qs


def test_fq_mul_kernel_kat():
    dev = _card()
    n = 4099
    a = [0, 1, Q - 1] + [rnd.randrange(Q) for _ in range(n - 3)]
    b = [Q - 1, 0, Q - 1] + [rnd.randrange(Q) for _ in range(n - 3)]

    def limbs(v):
        return torch.from_numpy(ints_to_limbs([FQ.to_mont(x) for x in v],
                                              FQ_LIMBS).T.astype(np.int32))

    ta, tb = limbs(a), limbs(b)
    before = kernels.LAUNCHES["fq_mul"]
    got = kernels.fq_mul(ta.to(dev), tb.to(dev)).cpu()
    assert kernels.LAUNCHES["fq_mul"] == before + 1
    assert torch.equal(got, kernels.fq_mul_plain(ta, tb))
    assert [FQ.from_mont(v) for v in limbs_to_ints(got.numpy().T)] == [
        x * y % Q for x, y in zip(a, b)]


def test_g1_add_kernel_kat():
    dev = _card()
    ps, qs = _pairs(515)
    dp, dq = points_to_device(ps, "cpu"), points_to_device(qs, "cpu")
    got = kernels.g1_add(PointsXYZ(*(c.to(dev) for c in dp)),
                         PointsXYZ(*(c.to(dev) for c in dq)))
    got = PointsXYZ(*(c.cpu() for c in got))
    assert all(torch.equal(a, b)
               for a, b in zip(got, kernels.g1_add_plain(dp, dq)))
    assert points_from_device(got) == [p.add(q) for p, q in zip(ps, qs)]


def test_fold_and_suffix_kernels_match_plain():
    dev = _card()
    rng = StdRng.seed_from_u64(3)
    pts = [rng.rand_g1() for _ in range(300)] + [G1.infinity()]
    bases = md.DeviceBases(pts, "cpu")
    ss = [rnd.randrange(R) for _ in range(len(pts))]
    params = md.pick_params(bases.n, 8)
    limbs = torch.from_numpy(md._scalars_to_limbs(ss, params.n)
                             .astype(np.int32))
    sp = md._slot_plan(md._signed_digits(limbs, params.n, 8), n=params.n,
                       c=8, t_rows=params.t_rows, s_pad=params.s_pad)
    ext = (bases.ext_px, bases.ext_py, bases.ext_zb, sp.plan)
    got = kernels.g1_fold_madd(*(t.to(dev) for t in ext))
    assert all(torch.equal(a.cpu(), b)
               for a, b in zip(got, kernels.g1_fold_madd_plain(*ext)))

    d = points_to_device(pts[:3 * 37], "cpu")
    xyz = [c.reshape(FQ_LIMBS, 3, 37) for c in d]
    got = kernels.g1_suffix_weighted(*(c.to(dev) for c in xyz))
    want = kernels.g1_suffix_weighted_plain(*xyz)
    assert all(torch.equal(a.cpu(), b)
               for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])))


@pytest.mark.parametrize("c", [8, 16])
def test_msm_device_on_card_both_windows(c):
    """The pipeline against the host, with every kernel of the default
    (mixed-add) path launched, g1_sqrt for the fresh bases' compressed
    upload (mirrors the TPU tier's end-to-end MSM KAT)."""
    _card()
    rng = StdRng.seed_from_u64(5)
    base = [rng.rand_g1() for _ in range(256)]
    n = 3000
    pts = [base[i % 256] for i in range(n)]
    ss = [rnd.randrange(R) for _ in range(n)]
    kernels.reset_launches()
    got = md.msm_device(pts, ss, c=c, device="cuda")
    assert {k for k, v in kernels.LAUNCHES.items() if v > 0} == {
        "fq_mul", "g1_add", "g1_fold_madd", "g1_suffix_weighted", "g1_sqrt"}
    assert got == HostBackend().msm(pts, ss)


def test_torch_backend_defaults_to_the_card():
    _card()
    from curdleproofs_tpu_torch.ops.backend import TorchBackend

    b = TorchBackend()
    assert b.device.type == "cuda"
    rng = StdRng.seed_from_u64(6)
    pts = [rng.rand_g1() for _ in range(40)]
    ss = [rnd.randrange(R) for _ in range(40)]
    assert b.msm(pts, ss) == HostBackend().msm(pts, ss)
    assert b.engine_counts["device"] == 1


def test_g1_sqrt_kernel_and_compressed_ingest():
    """The sqrt kernel against its plain version at a ragged width, and the
    compressed ingest around it (parity fix, identity lanes) against the
    uncompressed upload and the host's affine y."""
    dev = _card()
    rng = StdRng.seed_from_u64(7)
    pts = [rng.rand_g1() for _ in range(4096)]
    pts += [G1.infinity(), pts[5].neg(), pts[6].neg()]   # n = 4099
    n = len(pts)
    px, meta = native.export_mont_x(pts, n)
    pxp = md.u32_to_tensor(px, dev)
    before = kernels.LAUNCHES["g1_sqrt"]
    got = kernels.g1_sqrt(pxp)
    assert kernels.LAUNCHES["g1_sqrt"] == before + 1
    assert torch.equal(got, kernels.g1_sqrt_plain(pxp))
    ext = md._ingest_compressed(pxp, md.u32_to_tensor(meta, dev))
    upx, upy, uzb = native.export_mont_affine(pts, n)
    want = md._ingest_packed_mont(*(md.u32_to_tensor(a, dev)
                                    for a in (upx, upy, uzb)))
    assert all(torch.equal(a, b) for a, b in zip(ext, want))
    ys = [FQ.from_mont(v) for v in limbs_to_ints(
        md.unpack_pairs(ext[1][:, :n]).cpu().numpy().T.astype(np.uint32))]
    assert ys == [1 if p.is_infinity() else p.to_affine()[1] for p in pts]


def test_fold_packed_kernel_matches_plain():
    """The full-add fold on a plan with dead rows (the identity, zero
    digits, the sentinel) and duplicate bases."""
    dev = _card()
    rng = StdRng.seed_from_u64(8)
    pts = [rng.rand_g1() for _ in range(300)] + [G1.infinity()]
    pts[10] = pts[11]
    bases = md.DeviceBases(pts, "cpu")
    ss = [rnd.randrange(R) for _ in range(len(pts))]
    ss[4] = 0
    params = md.pick_params(bases.n, 8)
    limbs = torch.from_numpy(md._scalars_to_limbs(ss, params.n)
                             .astype(np.int32))
    sp = md._slot_plan(md._signed_digits(limbs, params.n, 8), n=params.n,
                       c=8, t_rows=params.t_rows, s_pad=params.s_pad)
    ext = (bases.ext_px, bases.ext_py, bases.ext_zb, sp.plan)
    before = kernels.LAUNCHES["g1_fold_packed"]
    got = kernels.g1_fold_packed(*(t.to(dev) for t in ext))
    assert kernels.LAUNCHES["g1_fold_packed"] == before + 1
    assert all(torch.equal(a.cpu(), b)
               for a, b in zip(got, kernels.g1_fold_packed_plain(*ext)))


def test_full_add_msm_on_card():
    _card()
    rng = StdRng.seed_from_u64(10)
    pts = [rng.rand_g1() for _ in range(700)]
    ss = [rnd.randrange(R) for _ in range(700)]
    kernels.reset_launches()
    assert md.msm_device(pts, ss, device="cuda", madd=False) == \
        HostBackend().msm(pts, ss)
    assert kernels.LAUNCHES["g1_fold_packed"] == 1
    assert kernels.LAUNCHES["g1_fold_madd"] == 0
    assert kernels.LAUNCHES["g1_sqrt"] == 1      # fresh bases, compressed


@pytest.mark.parametrize("async_worker", [False, True])
def test_stream_on_card(async_worker):
    _card()
    rng = StdRng.seed_from_u64(11)
    pts = [rng.rand_g1() for _ in range(1300)]
    ss = [rnd.randrange(R) for _ in range(1300)]
    stream = md.DeviceMsmStream(512, async_worker=async_worker)
    assert stream.device.type == "cuda"
    stream.add(pts[:900], ss[:900])
    stream.add(pts[900:], ss[900:])
    assert stream.result() == HostBackend().msm(pts, ss)
    assert stream.dispatches == 3
