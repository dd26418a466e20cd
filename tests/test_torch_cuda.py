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
    # c = 8 reduces 512 lanes (the tree entry), c = 16 32,768 (the chain)
    suffix = "g1_suffix_weighted_tree" if c == 8 else "g1_suffix_weighted"
    assert {k for k, v in kernels.LAUNCHES.items() if v > 0} == {
        "fq_mul", "g1_add", "g1_fold_madd", suffix, "g1_sqrt"}
    # the ingest's parity product and one leave-Montgomery product
    assert kernels.LAUNCHES["fq_mul"] == 2
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


def _adversarial_plan(n: int, t_rows: int, s: int, seed: int) -> torch.Tensor:
    """A [T, S] fold plan over the extended bases [P | -P | inf] (n points,
    sentinel 2n): live prefixes of random lengths, stray dead rows, and the
    special slots the fold must get right."""
    r = np.random.default_rng(seed)
    plan = r.integers(0, 2 * n, size=(t_rows, s))
    lengths = r.integers(0, t_rows + 1, size=s)
    plan[np.arange(t_rows)[:, None] >= lengths[None, :]] = 2 * n
    plan[r.random((t_rows, s)) < 0.05] = 2 * n    # dead rows inside a prefix
    plan[:, 0] = 2 * n                            # an all-dead slot
    plan[:, 1] = 5                                # one base T times: doubles
    plan[:, 2] = 2 * n
    plan[:2, 2] = [7, 7 + n]                      # P, then -P
    plan[:, 3] = 9
    plan[1::2, 3] = 9 + n                         # P, -P, P, -P, ...
    return torch.from_numpy(plan.astype(np.int32))


@pytest.mark.parametrize("t_rows", [8, 16])
def test_fold_madd_kernel_on_adversarial_plans(t_rows):
    """The redesigned fold (carry-chain core, bases repacked point-major)
    against its plain version on plans made to break it: an all-dead slot,
    a slot that gathers one base T times (the complete formula doubles),
    P and -P in one slot and alternating down another, dead rows inside
    live prefixes, and S = 300, not a multiple of the block's 128 slots."""
    dev = _card()
    rng = StdRng.seed_from_u64(12)
    pts = [rng.rand_g1() for _ in range(200)] + [G1.infinity()]
    bases = md.DeviceBases(pts, "cpu")
    plan = _adversarial_plan(bases.n, t_rows, 300, seed=t_rows)
    ext = (bases.ext_px, bases.ext_py, bases.ext_zb, plan)
    before = kernels.LAUNCHES["g1_fold_madd"]
    got = kernels.g1_fold_madd(*(t.to(dev) for t in ext))
    assert kernels.LAUNCHES["g1_fold_madd"] == before + 1
    want = kernels.g1_fold_madd_plain(*ext)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    pts_got = points_from_device(PointsXYZ(*(c.cpu() for c in got)))
    assert pts_got[0] == G1.infinity()
    assert pts_got[1] == pts[5].mul(t_rows)
    assert pts_got[2] == G1.infinity()


@pytest.mark.parametrize("t_rows", [8, 16])
def test_fold_packed_kernel_on_adversarial_plans(t_rows):
    """The full-add fold (carry-chain core, the warp's vote between the
    scale of dead rows and the complete add) against its plain version on
    `_adversarial_plan`'s plans, with whole warps of slots for each kind of
    warp row: slots 128-159 all live, 160-191 all dead of the ingest's
    kinds (the input infinity (0 : 1 : 0), its negation (0 : -1 : 0), the
    sentinel: 3 products), 192-223 all dead with x = 0, among them
    (0 : y : 0) with y not +-one (5 products); a dead row whose x is not 0
    (a base with its liveness bit cleared) in slot 224 and in the mixed
    slots 4-5; S = 300, not a multiple of a warp."""
    dev = _card()
    rng = StdRng.seed_from_u64(23)
    pts = [rng.rand_g1() for _ in range(200)] + [G1.infinity()]
    bases = md.DeviceBases(pts, "cpu")
    n = bases.n
    px, zb = bases.ext_px.clone(), bases.ext_zb.clone()
    zb[[17, 19]] = 0                 # 17: dead, x != 0; 19: dead (0 : y : 0)
    px[:, 19] = 0
    plan = _adversarial_plan(n, t_rows, 300, seed=30 + t_rows)
    r = np.random.default_rng(t_rows)
    live = np.setdiff1d(np.arange(2 * n), [17, 19, 200, 200 + n])
    plan[:, 128:160] = torch.from_numpy(
        r.choice(live, size=(t_rows, 32)).astype(np.int32))
    plan[:, 160:192] = torch.from_numpy(r.choice(
        [200, 200 + n, 2 * n], size=(t_rows, 32)).astype(np.int32))
    plan[:, 192:224] = torch.from_numpy(r.choice(
        [19, 200, 200 + n, 2 * n], size=(t_rows, 32)).astype(np.int32))
    plan[:, 192] = 19
    plan[t_rows // 2, 224] = plan[0, 4] = plan[-1, 5] = 17
    ext = (px, bases.ext_py, zb, plan)
    before = kernels.LAUNCHES["g1_fold_packed"]
    got = kernels.g1_fold_packed(*(t.to(dev) for t in ext))
    assert kernels.LAUNCHES["g1_fold_packed"] == before + 1
    want = kernels.g1_fold_packed_plain(*ext)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    pts_got = points_from_device(PointsXYZ(*(c.cpu() for c in got)))
    assert pts_got[0] == G1.infinity()
    assert pts_got[1] == pts[5].mul(t_rows)


def _general_rows(n: int, seed: int) -> PointsXYZ:
    """n points with a general z (complete sums of random pairs), on the
    CPU, with z = 0 (dead) in every 7th lane and infinity in every 11th."""
    rng = StdRng.seed_from_u64(seed)
    a = points_to_device([rng.rand_g1() for _ in range(n)], "cpu")
    b = points_to_device([rng.rand_g1() for _ in range(n)], "cpu")
    p = kernels.g1_add_plain(a, b)
    lane = torch.arange(n)
    inf = points_to_device([G1.infinity()], "cpu")
    x = torch.where((lane % 11 == 0)[None], inf.x, p.x)
    y = torch.where((lane % 11 == 0)[None], inf.y, p.y)
    z = torch.where((lane % 7 == 0)[None] | (lane % 11 == 0)[None], 0, p.z)
    return PointsXYZ(x, y, z)


@pytest.mark.parametrize("t_rows, s", [(8, 515), (1, 37), (1, 1), (5, 129)])
def test_fold_rows_kernel_matches_plain(t_rows, s):
    """g1_fold_rows on [24, T, S] rows with dead rows (z = 0), infinities,
    P and -P in one column and one point repeated down another."""
    dev = _card()
    p = _general_rows(t_rows * s, seed=13 + t_rows)
    rows = [c.reshape(FQ_LIMBS, t_rows, s).clone() for c in p]
    if t_rows > 1:
        neg = points_to_device([points_from_device(PointsXYZ(
            *(c[:, 0, 1:2] for c in rows)))[0].neg()], "cpu")
        for c, v in zip(rows, neg):
            c[:, 1, 1] = v[:, 0]                 # column 1: P, then -P
        for c in rows:
            c[:, :, 2] = c[:, :1, 2]             # column 2: P repeated
    before = kernels.LAUNCHES["g1_fold_rows"]
    got = kernels.g1_fold_rows(*(c.to(dev) for c in rows))
    assert kernels.LAUNCHES["g1_fold_rows"] == before + 1
    want = kernels.g1_fold_rows_plain(*rows)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_add_rows_kernel_matches_plain():
    dev = _card()
    p = _general_rows(515, seed=15)
    q = _general_rows(515, seed=16)
    q = PointsXYZ(*(torch.cat([a[:, :5], b[:, 5:]], dim=1)
                    for a, b in zip(p, q)))        # P + P in the first lanes
    before = dict(kernels.LAUNCHES)
    got = kernels.g1_add_rows(PointsXYZ(*(c.to(dev) for c in p)),
                              PointsXYZ(*(c.to(dev) for c in q)))
    assert kernels.LAUNCHES["g1_add_rows"] == before["g1_add_rows"] + 1
    assert kernels.LAUNCHES["g1_add"] == before["g1_add"]
    want = kernels.g1_add_rows_plain(p, q)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        kernels.g1_add_rows(PointsXYZ(*(c[:, :4].to(dev) for c in p)),
                            PointsXYZ(*(c[:, :5].to(dev) for c in q)))


def _adversarial_pairs(n: int) -> tuple[PointsXYZ, PointsXYZ]:
    """[24, n] point pairs on the CPU, general z (tiled from 256 complete
    sums, so wide batches stay cheap to make), with the complete add's
    special cases in the first lanes: both at infinity, one at infinity
    (either side), P = Q, P = -Q, and all-zero (0, 0, 0) rows."""
    p = _general_rows(256, seed=17)
    q = _general_rows(256, seed=18)
    idx = torch.arange(n) % 256
    p, q = (PointsXYZ(*(c[:, idx].clone() for c in v)) for v in (p, q))
    inf = points_to_device([G1.infinity()], "cpu")
    g = points_to_device([StdRng.seed_from_u64(19).rand_g1()], "cpu")
    neg = points_to_device([points_from_device(g)[0].neg()], "cpu")
    zero = PointsXYZ(*(torch.zeros_like(c) for c in inf))
    cases = [(inf, inf), (inf, g), (g, inf), (g, g), (g, neg), (zero, g),
             (g, zero), (zero, zero)]
    for lane, (a, b) in enumerate(cases[:n]):
        for c, v in zip((*p, *q), (*a, *b)):
            c[:, lane] = v[:, 0]
    return p, q


@pytest.mark.parametrize("n", [1, 37, 512, 32_768 + 3])
def test_g1_add_kernel_widths_and_special_points(n):
    """The carry-chain g1_add against its plain version at ragged widths,
    the special cases of the complete add in the first lanes."""
    dev = _card()
    p, q = _adversarial_pairs(n)
    before = kernels.LAUNCHES["g1_add"]
    got = kernels.g1_add(PointsXYZ(*(c.to(dev) for c in p)),
                         PointsXYZ(*(c.to(dev) for c in q)))
    assert kernels.LAUNCHES["g1_add"] == before + 1
    want = kernels.g1_add_plain(p, q)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def _scan_inputs(dev):
    """The fold's output and slot keys of a real 3000-point c = 8 plan
    (several slots a bucket), on the card."""
    rng = StdRng.seed_from_u64(20)
    base = [rng.rand_g1() for _ in range(256)]
    pts = [base[i % 256] for i in range(3000)] + [G1.infinity()]
    bases = md.DeviceBases(pts, dev)
    ss = [rnd.randrange(R) for _ in range(len(pts))]
    params = md.pick_params(bases.n, 8)
    limbs = torch.from_numpy(md._scalars_to_limbs(ss, params.n)
                             .astype(np.int32)).to(dev)
    sp = md._slot_plan(md._signed_digits(limbs, params.n, 8), n=params.n,
                       c=8, t_rows=params.t_rows, s_pad=params.s_pad)
    acc = kernels.g1_fold_madd(bases.ext_px, bases.ext_py, bases.ext_zb,
                               sp.plan)
    return acc, sp


def test_scan_step_kernel_on_a_slot_plan():
    """g1_add's scan entry against its plain version, round by round, on a
    real plan's merge (kmax > 1), counted under g1_add."""
    dev = _card()
    acc, sp = _scan_inputs(dev)
    assert sp.kmax > 2
    v, stride = acc, 1
    while stride < sp.kmax:
        before = kernels.LAUNCHES["g1_add"]
        got = kernels.g1_add_scan(v, sp.slot_gkey, stride)
        assert kernels.LAUNCHES["g1_add"] == before + 1
        want = kernels.g1_add_scan_plain(v, sp.slot_gkey, stride)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        v, stride = got, stride * 2


@pytest.mark.parametrize("stride", [1, 2, 64, 4099])
def test_scan_step_kernel_on_alternating_keys(stride):
    """Keys that alternate lane by lane (equal keys two lanes apart, never
    next to each other), at a ragged width, with strides past the width."""
    dev = _card()
    p, _ = _adversarial_pairs(4099)
    v = PointsXYZ(*(c.to(dev) for c in p))
    key = (torch.arange(4099, device=dev) % 2).long()
    got = kernels.g1_add_scan(v, key, stride)
    want = kernels.g1_add_scan_plain(v, key, stride)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if stride % 2:                       # odd strides: nothing merges
        assert all(torch.equal(a, b) for a, b in zip(got, v))


@pytest.mark.parametrize("n", [1, 64, 4099])
def test_g1_sqrt_kernel_widths(n):
    """The carry-chain sqrt chain against its plain version; lane 0 is the
    identity's x = 0."""
    dev = _card()
    rng = StdRng.seed_from_u64(21)
    pts = [G1.infinity()] + [rng.rand_g1() for _ in range(min(n, 256) - 1)]
    pts = [pts[i % len(pts)] for i in range(n)]
    px, _ = native.export_mont_x(pts, n)
    pxp = md.u32_to_tensor(px, dev)
    got = kernels.g1_sqrt(pxp)
    assert torch.equal(got, kernels.g1_sqrt_plain(pxp))


@pytest.mark.parametrize("n", [1, 37, 128, 768, 4099])
def test_g1_sqrt_both_entries(n):
    """Both entries of g1_sqrt.cu (one thread a point, a pair of lanes a
    point) against the plain version, at widths with a ragged warp and
    block; the routed wrapper takes the entry `sqrt_uses_pair` names, and
    each launch counts under `g1_sqrt` and its entry."""
    dev = _card()
    rng = StdRng.seed_from_u64(23)
    pts = [G1.infinity()] + [rng.rand_g1() for _ in range(min(n, 256) - 1)]
    pts = [pts[i % len(pts)] for i in range(n)]
    px, _ = native.export_mont_x(pts, n)
    pxp = md.u32_to_tensor(px, dev)
    want = kernels.g1_sqrt_plain(pxp)
    for pair in (False, True, None):
        entry = "g1_sqrt_pair" if (kernels.sqrt_uses_pair(n) if pair is None
                                   else pair) else "g1_sqrt"
        before = dict(kernels.LAUNCHES_BY_ENTRY)
        n_before = kernels.LAUNCHES["g1_sqrt"]
        got = kernels.g1_sqrt(pxp, pair=pair)
        assert kernels.LAUNCHES["g1_sqrt"] == n_before + 1
        assert {e: v - before[e] for e, v in kernels.LAUNCHES_BY_ENTRY.items()
                if v != before[e]} == {entry: 1}
        assert torch.equal(got, want), pair


@pytest.mark.parametrize("n", [1, 37, 512, 4099])
def test_g1_add_both_entries(n):
    """Both designs of g1_add.cu's flat and scan entries (one thread a
    lane, a group of 8 lanes a point) against the plain versions on the
    complete add's special cases (infinities, P + P, P + -P, all-zero
    rows) at ragged widths; the scan step on alternating keys at strides
    1 and 2 and past the width; the routed wrappers take the entries
    `add_uses_group` names."""
    dev = _card()
    p, q = _adversarial_pairs(n)
    dp, dq = (PointsXYZ(*(c.to(dev) for c in v)) for v in (p, q))
    want = kernels.g1_add_plain(p, q)
    key = (torch.arange(n) % 2).long()
    routed = kernels.add_uses_group(n)
    for group in (False, True, None):
        grp = routed if group is None else group
        before = dict(kernels.LAUNCHES_BY_ENTRY)
        got = kernels.g1_add(dp, dq, group=group)
        assert {e: v - before[e] for e, v in kernels.LAUNCHES_BY_ENTRY.items()
                if v != before[e]} == {
            "g1_add_group" if grp else "g1_add": 1}
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), group
        for stride in (1, 2, n + 1):
            before = dict(kernels.LAUNCHES_BY_ENTRY)
            got = kernels.g1_add_scan(dp, key.to(dev), stride, group=group)
            assert {e: v - before[e]
                    for e, v in kernels.LAUNCHES_BY_ENTRY.items()
                    if v != before[e]} == {
                "g1_add_scan_group" if grp else "g1_add_scan": 1}
            sw = kernels.g1_add_scan_plain(p, key, stride)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, sw)), \
                (group, stride)


def test_scan_step_group_entry_on_a_slot_plan():
    """The scan step's group entry, round by round over a real plan's
    merge, array-equal to the one-thread entry and the plain version."""
    dev = _card()
    acc, sp = _scan_inputs(dev)
    v, stride = acc, 1
    while stride < sp.kmax:
        got = kernels.g1_add_scan(v, sp.slot_gkey, stride, group=True)
        one = kernels.g1_add_scan(v, sp.slot_gkey, stride, group=False)
        want = kernels.g1_add_scan_plain(v, sp.slot_gkey, stride)
        assert all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(got, one, want))
        v, stride = got, stride * 2


def _suffix_buckets(cb: int, wg: int) -> list[torch.Tensor]:
    """[24, Cb, WG] buckets on the CPU (bucket j of lane l at column
    j * WG + l), general z, with special lanes: every bucket at infinity;
    P and -P alternating; one point in every bucket; all-zero (0, 0, 0)
    rows in every other bucket."""
    p, _ = _adversarial_pairs(cb * wg)
    rows = [c.reshape(FQ_LIMBS, cb, wg).clone() for c in p]
    g = points_to_device([StdRng.seed_from_u64(22).rand_g1()], "cpu")
    neg = points_to_device([points_from_device(g)[0].neg()], "cpu")
    inf = points_to_device([G1.infinity()], "cpu")
    zero = PointsXYZ(*(torch.zeros_like(c) for c in inf))
    for lane, fill in enumerate((
            lambda j: inf, lambda j: g if j % 2 else neg, lambda j: g,
            lambda j: zero if j % 2 else g)[:wg]):
        for j in range(cb):
            for c, v in zip(rows, fill(j)):
                c[:, j, lane] = v[:, 0]
    return rows


@pytest.mark.parametrize("cb, wg", [(3, 37), (8, 512), (16, 4099)])
def test_suffix_weighted_entries_widths_and_special_points(cb, wg):
    """The carry-chain chain entry against `g1_suffix_weighted_plain` and,
    at Cb = 8 and 16, the tree entry against `g1_suffix_weighted_tree_plain`
    (array equality); the routed wrapper takes the entry `suffix_uses_tree`
    names."""
    dev = _card()
    rows = _suffix_buckets(cb, wg)
    on = [c.to(dev) for c in rows]
    entries = [(False, "g1_suffix_weighted",
                kernels.g1_suffix_weighted_plain)]
    if cb in (8, 16):
        entries.append((True, "g1_suffix_weighted_tree",
                        kernels.g1_suffix_weighted_tree_plain))
    for tree, name, plain in entries:
        before = kernels.LAUNCHES[name]
        got = kernels.g1_suffix_weighted(*on, tree=tree)
        assert kernels.LAUNCHES[name] == before + 1
        want = plain(*rows)
        assert all(torch.equal(a.cpu(), b)
                   for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])))
    name = "g1_suffix_weighted_tree" if kernels.suffix_uses_tree(cb, wg) \
        else "g1_suffix_weighted"
    before = kernels.LAUNCHES[name]
    kernels.g1_suffix_weighted(*on)
    assert kernels.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("n", [1, 37, 96, 1 << 16])
def test_fq_mul_kernel_widths_and_broadcast(n):
    """The carry-chain product against `fq_mul_plain` at ragged widths, with
    edge residues in the first lanes, and each operand broadcast from one
    column (as leave-Montgomery's plain 1, also as [24, 1, 1] against
    [24, 3, n]) or from [24, 1, n] to [24, 3, n]."""
    dev = _card()
    vals = [0, 1, Q - 1, FQ.to_mont(1)] + [rnd.randrange(Q) for _ in range(
        min(n, 4096))]
    vals = [vals[i % len(vals)] for i in range(n)]

    def limbs(v):
        return torch.from_numpy(ints_to_limbs(v, FQ_LIMBS).T.astype(np.int32))

    a, b = limbs(vals), limbs(vals[::-1])
    col = limbs([FQ.to_mont(5)])
    three = torch.stack([a, b, a], dim=1)                 # [24, 3, n]
    for x, y in ((a, b), (a, col), (col, b), (three, a[:, None]),
                 (col[:, None], three)):
        before = kernels.LAUNCHES["fq_mul"]
        got = kernels.fq_mul(x.to(dev), y.to(dev))
        assert kernels.LAUNCHES["fq_mul"] == before + 1
        assert torch.equal(got.cpu(), kernels.fq_mul_plain(x, y))


# --------------------------------------------------------------------------
# the grouped MSM and the batched prover
# --------------------------------------------------------------------------

def _grouped_relations():
    """A pool of 64 points and 12 relations over it: random widths up to
    40, negatives, zeros, digits at half, a top-window carry, a repeated
    base and one column."""
    rng = StdRng.seed_from_u64(7)
    pool = [rng.rand_g1() for _ in range(64)]
    grnd = random.Random(3)
    rels = []
    for _ in range(6):
        w = grnd.randrange(3, 41)
        rels.append((grnd.sample(range(64), w),
                     [grnd.randrange(R) for _ in range(w)]))
    cols = list(range(8))
    rels += [(cols, [R - 1] * 8), (cols, [0] * 8), (cols, [8] * 8),
             (cols, [(1 << 252) + 7] * 8), ([3] * 8, [5] * 8),
             ([9], [12345])]
    return pool, rels


def _grouped_inputs(rels, n_rel, width, dev):
    from curdleproofs_tpu_torch.ops import msm_grouped as mg

    return mg.upload_relations(*mg.pack_relations(rels, n_rel, width, 64),
                               dev)


@pytest.mark.parametrize("madd", [True, False])
def test_grouped_slot_on_card(madd):
    """Slot mode on the card: its plan equals the CPU's, its fold the plain
    fold's words, its points the CPU run's and the host MSM's (the c = 4
    reduction's 1,024 lanes go to the suffix kernel's tree entry, so the
    window sums are other representatives: points compare)."""
    from curdleproofs_tpu_torch.ops import msm_grouped as mg

    dev = _card()
    pool, rels = _grouped_relations()
    cpu, card = md.DeviceBases(pool, "cpu"), md.DeviceBases(pool, dev)
    width = max(len(c) for c, _ in rels)
    params = mg.pick_grouped_params(len(rels), width, cpu.n)
    plans = []
    for b in (cpu, card):
        lt, ct = _grouped_inputs(rels, params.n_rel, width, b.device)
        digits = mg._digits(lt, params.n_rel, width)
        plans.append(mg.grouped_plan(digits, ct, params))
    assert torch.equal(plans[1].plan.cpu(), plans[0].plan)
    assert torch.equal(plans[1].slot_gkey.cpu(), plans[0].slot_gkey)
    fold, plain = ((kernels.g1_fold_madd, kernels.g1_fold_madd_plain) if madd
                   else (kernels.g1_fold_packed, kernels.g1_fold_packed_plain))
    got = fold(card.ext_px, card.ext_py, card.ext_zb, plans[1].plan)
    want = plain(cpu.ext_px, cpu.ext_py, cpu.ext_zb, plans[0].plan)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))

    kernels.reset_launches()
    pts = mg.grouped_msm(card, rels, madd=madd)
    assert {k for k, v in kernels.LAUNCHES.items() if v} == {
        "g1_add", "g1_suffix_weighted_tree", "g1_horner",
        "g1_fold_madd" if madd else "g1_fold_packed"}
    assert kernels.LAUNCHES["g1_horner"] == 1    # Horner, leave-Montgomery
    host = [HostBackend().msm([pool[c] for c in cc], ss) for cc, ss in rels]
    assert pts == host == mg.grouped_msm(cpu, rels, madd=madd)


@pytest.mark.parametrize("madd", [True, False])
def test_grouped_table_on_card(madd):
    """Table mode on the card: the multiples table and the output are
    array-equal to the CPU run's (no reduction step, so the same
    representatives), the points the host MSM's."""
    from curdleproofs_tpu_torch.ops import msm_grouped as mg

    dev = _card()
    pool, rels = _grouped_relations()
    cpu_b = md.DeviceBases(pool[:60], "cpu")     # 4 dead padding bases
    kernels.reset_launches()
    card = mg.DeviceBasesTable(md.DeviceBases(pool[:60], dev))
    assert kernels.LAUNCHES["g1_add"] == 7       # the multiples 2P..8P
    cpu = mg.DeviceBasesTable(cpu_b)
    for a, b in zip((card.ext_px, card.ext_py, card.ext_zb),
                    (cpu.ext_px, cpu.ext_py, cpu.ext_zb)):
        assert torch.equal(a.cpu(), b)
    width = max(len(c) for c, _ in rels)
    outs = []
    for t in (card, cpu):
        lt, ct = _grouped_inputs(rels, 16, width, t.device)
        kernels.reset_launches()
        outs.append(mg.grouped_table_run(t.ext_px, t.ext_py, t.ext_zb, lt, ct,
                                         n_rel=16, width=width, n_base=t.n,
                                         madd=madd).cpu())
        if t is card:
            assert {k for k, v in kernels.LAUNCHES.items() if v} == {
                "g1_horner", "g1_fold_madd" if madd else "g1_fold_packed"}
            assert kernels.LAUNCHES["g1_horner"] == 1     # Horner
    assert torch.equal(outs[0], outs[1])
    padded = pool[:60] + [G1.infinity()] * 4
    host = [HostBackend().msm([padded[c] for c in cc], ss) for cc, ss in rels]
    from curdleproofs_tpu_torch.ops.msm_grouped import decode_points

    assert decode_points(outs[0].numpy())[: len(rels)] == host


@pytest.mark.parametrize("n_rel", [8, 37, 40, 100])
def test_horner_kernel_matches_plain(n_rel):
    """g1_horner at ragged widths (a block, at 37 also a warp, partly past
    the last relation: groups of 8 lanes a relation, 4 a warp, 16 a block),
    array-equal to its plain version (the complete doubling gives the
    complete self-add's words on the curve), on window sums with points at
    infinity (0 : 1 : 0) among them."""
    dev = _card()
    ps, qs = _pairs(n_rel * 64)
    s = kernels.g1_add_plain(points_to_device(ps, "cpu"),
                             points_to_device(qs, "cpu"))   # general z
    ws = PointsXYZ(*(c.reshape(FQ_LIMBS, n_rel, 64) for c in s))
    want = kernels.g1_horner_plain(*ws)
    before = kernels.LAUNCHES["g1_horner"]
    got = kernels.g1_horner(*(c.to(dev) for c in ws))
    assert kernels.LAUNCHES["g1_horner"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("table", ["1", "0"])
def test_batch_prove_on_card(table, monkeypatch):
    """The batched prover at l = 12 (3 instances) on `TorchBackend()`, in
    table and slot mode: the sequential host prover's bytes."""
    _card()
    from curdleproofs_tpu_torch.backend import use_backend
    from curdleproofs_tpu_torch.curdleproofs import (
        CurdleproofsProof, generate_crs,
    )
    from curdleproofs_tpu_torch.ops.backend import TorchBackend
    from curdleproofs_tpu_torch.parallel import batch_prove as bp
    from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

    monkeypatch.setenv("CURDLEPROOFS_TABLE", table)
    ell = 12

    def instances():
        out = []
        with use_backend(HostBackend()):
            crs = generate_crs(ell)
            for i in range(3):
                g = StdRng.seed_from_u64(40 + i)
                vr = [g.rand_g1() for _ in range(ell)]
                vs = [g.rand_g1() for _ in range(ell)]
                perm = list(range(ell))
                g.shuffle(perm)
                k = g.rand_fr()
                T, U, M, mb = shuffle_permute_and_commit_input(
                    crs, vr, vs, perm, k, g)
                out.append(bp.ProveInstance(vr, vs, T, U, M, perm, k, mb, g))
        return crs, out

    crs, insts = instances()
    with use_backend(HostBackend()):
        want = [CurdleproofsProof.new(
            crs, i.vec_R, i.vec_S, i.vec_T, i.vec_U, i.M, i.permutation, i.k,
            i.vec_m_blinders, i.rng).serialize() for i in insts]
    crs, insts = instances()
    kernels.reset_launches()
    with use_backend(TorchBackend()):
        got = bp.batch_prove(crs, insts)
    assert [p.serialize() for p in got] == want
    assert kernels.LAUNCHES["g1_sqrt"] == 1      # one compressed upload
    assert bp.batch_prove.last_timings["dispatches"] == 12


def _ladder_points(n: int, seed: int):
    """n host points (lane 1 at infinity) and their [24, n] int32 limbs on
    the CPU as projective representatives (l x : l y : l), where every
    third lane from 2 on takes the l that puts x, y or z (in turn) at
    q - 1 - lane in Montgomery form: inputs near q."""
    rng = StdRng.seed_from_u64(seed)
    pts = [rng.rand_g1() for _ in range(n)]
    pts[1] = G1.infinity()
    cols = []
    for j, p in enumerate(pts):
        if p.is_infinity():
            cols.append([0, FQ.to_mont(1), 0])
            continue
        c = [*p.to_affine(), 1]
        if j >= 2 and j % 3 == 2:
            lam = FQ.from_mont(Q - 1 - j) * pow(c[j % 9 // 3], -1, Q) % Q
        else:
            lam = rnd.randrange(1, Q)
        cols.append([FQ.to_mont(v * lam % Q) for v in c])
    limbs = PointsXYZ(*(torch.from_numpy(ints_to_limbs(list(col), FQ_LIMBS)
                                         .T.astype(np.int32))
                        for col in zip(*cols)))
    return pts, limbs


@pytest.mark.parametrize("n", [8, 124])
def test_ladder_kernel_entries_match_plain(n):
    """The three entries of g1_ladder.cu against
    `g1_ladder_plain` after affine normalization (the GLV chain adds in
    another order), on inputs near q and infinity: one scalar (0, 1, 2,
    r - 1, lambda and a random one at n = 8), one a point, and the fold;
    the results against the host's multiples."""
    dev = _card()
    from curdleproofs_tpu_torch.ops import msm
    from curdleproofs_tpu_torch.ops.limbs import ints_to_bits

    pts, p = _ladder_points(n, 30 + n)
    left_pts, left = _ladder_points(n, 31 + n)
    on = (lambda v: PointsXYZ(*(c.to(dev) for c in v)))
    from curdleproofs_tpu_torch.host.glv import LAMBDA

    ks = [0, 1, 2, R - 1, LAMBDA, rnd.randrange(R)] if n == 8 \
        else [rnd.randrange(R)]
    each = [0, 1, 2, R - 1] + [rnd.randrange(R) for _ in range(n - 4)]
    cases = [(k, msm.scalar_words(ints_to_bits([k], msm.NBITS)[0], "cpu"),
              None) for k in ks]
    cases.append((each, msm.scalar_words(ints_to_bits(each, msm.NBITS),
                                         "cpu", True), None))
    gamma = rnd.randrange(R)
    cases.append((gamma, msm.scalar_words(
        ints_to_bits([gamma], msm.NBITS)[0], "cpu"), left))
    for k, words, lf in cases:
        before = kernels.LAUNCHES["g1_ladder"]
        got = kernels.g1_ladder(on(p), words, None if lf is None else on(lf))
        assert kernels.LAUNCHES["g1_ladder"] == before + 1
        got = PointsXYZ(*(c.cpu() for c in got))
        want = kernels.g1_ladder_plain(p, words, lf)
        assert points_from_device(got) == points_from_device(want)
        ks_ = k if isinstance(k, list) else [k] * n
        host = [q.mul(s) for q, s in zip(pts, ks_)]
        if lf is not None:
            host = [a.add(b) for a, b in zip(left_pts, host)]
        assert points_from_device(got) == host


def test_device_backend_on_card():
    """The all-device backend's ladder ops on the card against the host
    backend; each is one g1_ladder launch."""
    _card()
    from curdleproofs_tpu_torch.ops.backend import DeviceBackend

    rng = StdRng.seed_from_u64(33)
    pts = [rng.rand_g1() for _ in range(40)]
    ks = [rnd.randrange(R) for _ in range(40)]
    b, h = DeviceBackend(), HostBackend()
    kernels.reset_launches()
    assert b.batch_mul(pts, ks[0]) == h.batch_mul(pts, ks[0])
    assert b.batch_mul_each(pts, ks) == h.batch_mul_each(pts, ks)
    assert b.fold_points(pts[:20], pts[20:], ks[1]) == h.fold_points(
        pts[:20], pts[20:], ks[1])
    assert kernels.LAUNCHES["g1_ladder"] == 3
    assert b.msm(pts, ks) == h.msm(pts, ks) and b.last_msm_engine == "device"


def test_hybrid_backend_routes_as_the_table_says(tmp_path, monkeypatch):
    """With a table for the card, HybridBackend puts an MSM on the card
    exactly where `route_to_device` says: fresh bases to the host, the
    same bases once resident to the card.  A `"cpu"` entry that would say
    otherwise changes nothing on the card."""
    _card()
    import json

    from curdleproofs_tpu_torch.ops import msm_tune
    from curdleproofs_tpu_torch.ops.backend import HybridBackend

    path = tmp_path / "tune.json"
    path.write_text(json.dumps({
        "cuda": {"1024": {"c": 8, "device_warm_ms": 1.0,
                          "fresh_prep_ms": 100.0, "host_ms": 50.0}},
        "cpu": {"1024": {"c": 8, "device_warm_ms": 0.0,
                         "fresh_prep_ms": 0.0, "host_ms": 50.0}}}))
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(path))
    msm_tune._load_raw.cache_clear()
    try:
        rng = StdRng.seed_from_u64(34)
        pts = [rng.rand_g1() for _ in range(300)]
        ss = [rnd.randrange(R) for _ in range(300)]
        want = HostBackend().msm(pts, ss)
        b = HybridBackend()
        assert msm_tune.route_to_device(300, False) is False
        assert b.msm(pts, ss) == want and b.last_msm_engine == "host"
        md.prepare_bases(pts, "cuda")
        assert msm_tune.route_to_device(300, True) is True
        kernels.reset_launches()
        assert b.msm(pts, ss) == want and b.last_msm_engine == "device"
        assert kernels.LAUNCHES["g1_fold_madd"] == 1
        assert b.engine_counts == {"device": 1, "host": 1}
    finally:
        msm_tune._load_raw.cache_clear()


def test_committed_tune_table_sets_the_cards_window_widths(monkeypatch):
    """The table the port ships loads under "cuda", each family's measured
    c is the one `pick_params` takes on the card, and an MSM of the
    smallest family runs at it (the suffix entry of its c) and equals the
    host's."""
    dev = _card()
    import pathlib

    from curdleproofs_tpu_torch.ops import msm_tune

    monkeypatch.delenv("CURDLEPROOFS_TUNE", raising=False)
    msm_tune._load_raw.cache_clear()
    try:
        assert msm_tune.table_path() == pathlib.Path(
            msm_tune.__file__).with_name("msm_tune.json")
        table = msm_tune.load_table(dev)
        assert sorted(table) == [1 << k for k in (7, 8, 9, 10, 12, 14, 16,
                                                  18, 20)]
        assert msm_tune.table_stamp()["card"].startswith("NVIDIA H100")
        for n, e in table.items():
            assert msm_tune.tuned_c(n, dev) == e["c"]
            p = md.pick_params(n, device=dev)
            assert (p.n, p.c, p.t_rows, p.s_pad) == (n, e["c"], e["t_rows"],
                                                     e["s_pad"])
        n = min(table)
        rng = StdRng.seed_from_u64(35)
        pts = [rng.rand_g1() for _ in range(n)]
        ss = [rnd.randrange(R) for _ in range(n)]
        bases = md.DeviceBases(pts, dev)
        kernels.reset_launches()
        assert md.msm_device(bases, ss) == HostBackend().msm(pts, ss)
        entry = ("g1_suffix_weighted_tree" if table[n]["c"] == 8
                 else "g1_suffix_weighted")
        assert kernels.LAUNCHES[entry] == 1
    finally:
        msm_tune._load_raw.cache_clear()


# --------------------------------------------------------------------------
# the sharded MSM on logical grids over the one card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1 << 12])
@pytest.mark.parametrize("grid", [(4, 2), (6, 1)])
def test_sharded_msm_on_a_logical_grid(grid, n):
    """`sharded_msm` over a (Dp, Dw) grid whose every cell is cuda:0,
    against the host: (4, 2) reduces its points axis by a tree of
    g1_add launches, (6, 1) on the host.  The plain upload does not run
    g1_sqrt."""
    dev = _card()
    from curdleproofs_tpu_torch.parallel.sharded_msm import (
        make_msm_mesh, sharded_msm,
    )

    rng = StdRng.seed_from_u64(40)
    base = [rng.rand_g1() for _ in range(256)]
    pts = [base[i % 256] for i in range(n)]
    ss = [rnd.randrange(R) for _ in range(n)]
    mesh = make_msm_mesh(grid[0] * grid[1], grid[1], devices=[dev] * 8)
    assert mesh.devices.shape == grid
    kernels.reset_launches()
    assert sharded_msm(pts, ss, mesh) == HostBackend().msm(pts, ss)
    assert kernels.LAUNCHES["g1_fold_madd"] == grid[0] * grid[1]
    assert kernels.LAUNCHES["g1_sqrt"] == 0


@pytest.mark.parametrize("c, dw", [(8, 2), (8, 4), (8, 8), (16, 2), (16, 4),
                                   (16, 8)])
def test_suffix_entries_at_window_shard_shapes(c, dw):
    """The suffix kernel at the (Cb, WG) a window shard of Dw hands it:
    the entry `suffix_uses_tree` routes to against its plain version, and
    the chain entry against `g1_suffix_weighted_plain` (array equality)."""
    dev = _card()
    w_local = -(-255 // c) // dw
    g, cb = md._phase3_chunks(c, w_local)
    wg = w_local * g
    p, q = _adversarial_pairs(512)
    idx = torch.arange(cb * wg) % 1024
    rows = [torch.cat([a, b], dim=1)[:, idx].reshape(FQ_LIMBS, cb, wg)
            .to(dev) for a, b in zip(p, q)]
    entries = [(False, "g1_suffix_weighted",
                kernels.g1_suffix_weighted_plain)]
    if kernels.suffix_uses_tree(cb, wg):
        entries.append((True, "g1_suffix_weighted_tree",
                        kernels.g1_suffix_weighted_tree_plain))
    for tree, name, plain in entries:
        before = kernels.LAUNCHES[name]
        got = kernels.g1_suffix_weighted(*rows, tree=tree)
        assert kernels.LAUNCHES[name] == before + 1
        want = plain(*rows)
        assert all(torch.equal(a, b)
                   for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])))


def test_batch_verify_on_a_logical_grid():
    """`batch_verify(mesh=...)` at l = 28 on a (4, 2) grid over cuda:0:
    accepts the batch, rejects a swapped instance, and `identify` names
    it, as the one-MSM verification does."""
    dev = _card()
    from curdleproofs_tpu_torch.backend import use_backend
    from curdleproofs_tpu_torch.curdleproofs import (
        CurdleproofsProof, generate_crs,
    )
    from curdleproofs_tpu_torch.parallel import batch_verify as bv
    from curdleproofs_tpu_torch.parallel.sharded_msm import make_msm_mesh
    from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

    ell = 28
    rng = StdRng.seed_from_u64(41)
    crs = generate_crs(ell)
    insts, proofs = [], []
    with use_backend(HostBackend()):
        for _ in range(3):
            perm = list(range(ell))
            rng.shuffle(perm)
            k = rng.rand_fr()
            vr = [rng.rand_g1() for _ in range(ell)]
            vs = [rng.rand_g1() for _ in range(ell)]
            T, U, M, mb = shuffle_permute_and_commit_input(crs, vr, vs, perm,
                                                           k, rng)
            proofs.append(CurdleproofsProof.new(crs, vr, vs, T, U, M, perm,
                                                k, mb, rng))
            insts.append(bv.ShuffleInstance(vr, vs, T, U, M))
    bad = list(insts)
    bad[2] = bv.ShuffleInstance(insts[2].vec_S, insts[2].vec_R,
                                insts[2].vec_T, insts[2].vec_U, insts[2].M)
    mesh = make_msm_mesh(8, 2, devices=[dev] * 8)
    kernels.reset_launches()
    with use_backend(HostBackend()):
        assert bv.batch_verify(crs, insts, proofs, rng, mesh=mesh) is True
        assert bv.batch_verify(crs, bad, proofs, rng, mesh=mesh) is False
        assert bv.batch_verify(crs, bad, proofs, rng, mesh=mesh,
                               identify=True) == [True, True, False]
        assert bv.batch_verify(crs, bad, proofs, rng) is False
    assert kernels.LAUNCHES["g1_fold_madd"] > 0


# the warm-up's launches of every C entry, counted by kernel name
WARM_LAUNCHES = {"fq_mul": 1, "g1_add": 4, "g1_fold_madd": 1,
                 "g1_fold_packed": 1, "g1_suffix_weighted": 1,
                 "g1_suffix_weighted_tree": 2, "g1_sqrt": 2,
                 "g1_fold_rows": 1, "g1_ladder": 3, "g1_horner": 1}


def test_store_hit_launches_every_entry(monkeypatch):
    """Every library from a kernel store hit (a fresh process's view: the
    loaded records and the bound entries dropped), each C entry launched
    once, counted apart from LAUNCHES; then fq_mul at leave-Montgomery's
    [24, 96] equal to its plain version."""
    from curdleproofs_tpu_torch.ops import aot

    dev = _card()
    aot.export()                       # fills the store where it lacks
    monkeypatch.setattr(aot, "_LOADED", {})
    kernels._lib.cache_clear()
    before = dict(kernels.LAUNCHES)
    times = {}
    with kernels.launches_into({}) as apart:
        kernels.warm_entries(dev, times)
    torch.cuda.synchronize()
    assert apart == WARM_LAUNCHES
    assert kernels.LAUNCHES == before
    assert len(times) == 17 and all(ms > 0 for ms in times.values())
    for s in aot.SOURCES:
        rec = aot.maybe_load(s)
        assert rec is not None and rec["built"] is False, s
        assert "registers" in rec["ptxas"]
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, 1 << 16, (24, 96), dtype=np.int32))
    b = torch.from_numpy(rng.integers(0, 1 << 16, (24, 1), dtype=np.int32))
    a[-1] &= 0x0FFF                    # residues below q
    b[-1] &= 0x0FFF
    got = kernels.fq_mul(a.to(dev), b.to(dev)).cpu()
    assert torch.equal(got, kernels.fq_mul_plain(a, b))


def test_background_init_on_card(monkeypatch):
    from curdleproofs_tpu_torch.ops import warmup

    _card()
    monkeypatch.setattr(warmup, "_thread", None)
    monkeypatch.setattr(warmup, "_result", {})
    before = dict(kernels.LAUNCHES)
    warmup.start_background_init()
    r = warmup.wait_ready(timeout=600)
    assert "error" not in r, r
    assert 0 < r["init_s"] <= r["total_s"]
    assert r["launches"] == WARM_LAUNCHES
    assert kernels.LAUNCHES == before
