"""Port G1 ops (curdleproofs_tpu_torch.ops.g1_ops and the kernels' plain
versions) against the JAX package on the same inputs.

Tolerances: array equality of the limb arrays wherever both sides run the
same formula in the same order (complete add, mixed add, doubling, the
bucket-reduction suffix); affine point equality for the bucket fold, whose
JAX non-Pallas branch runs the 12-multiply full add where the kernel runs
the 11-multiply mixed add with a select on dead rows (different projective
representatives of the same points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from curdleproofs_tpu.host.g1 import G1
from curdleproofs_tpu.host.rng import StdRng
from curdleproofs_tpu.ops import g1_ops as jg
from curdleproofs_tpu.ops import msm_device as jmd
from curdleproofs_tpu.ops.field import FQ as JFQ
from curdleproofs_tpu.ops.limbs import FQ_LIMBS as L
from curdleproofs_tpu_torch.host.g1 import G1 as TG1
from curdleproofs_tpu_torch.ops import kernels
from curdleproofs_tpu_torch.ops.g1_ops import (
    PointsXYZ, g1_add, g1_double, g1_madd64, g1_select, points_from_device,
    points_to_device,
)

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32))


def _tp(p):
    return PointsXYZ(*(_t(c) for c in p))


def _eq(t, j):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


def _host(p: G1) -> TG1:
    return TG1.infinity() if p.is_infinity() else TG1.from_affine(
        *p.to_affine())


def _pairs():
    rng = StdRng.seed_from_u64(7)
    ps = [rng.rand_g1() for _ in range(6)]
    qs = [rng.rand_g1() for _ in range(6)]
    # exceptional cases the complete formulas cover: P = Q, P = -Q, infinity
    ps += [qs[0], qs[1].neg(), G1.infinity(), ps[0], G1.infinity()]
    qs += [qs[0], qs[1], qs[2], G1.infinity(), G1.infinity()]
    return ps, qs


def test_complete_add_and_double_match_jax_and_host():
    ps, qs = _pairs()
    dp, dq = jg.points_to_device(ps), jg.points_to_device(qs)
    got = g1_add(_tp(dp), _tp(dq))
    want = jax.jit(jg._g1_add_jnp)(dp, dq)
    assert all(_eq(a, b) for a, b in zip(got, want))
    assert points_from_device(got) == [_host(p.add(q)) for p, q in zip(ps, qs)]

    got = g1_double(_tp(dp))
    want = jax.jit(jg.g1_double)(dp)
    assert all(_eq(a, b) for a, b in zip(got, want))
    assert points_from_device(got) == [_host(p.double()) for p in ps]


def test_mixed_add_matches_jax_rows():
    """`g1_madd64` against the JAX kernel body `_k_g1_madd` run on plain jnp
    rows (as tests/test_g1_madd.py runs it): array equality."""
    from curdleproofs_tpu.ops.pallas_kernels import _k_g1_madd

    ps, qs = _pairs()
    ps, qs = ps[:9], qs[:9]  # the second point must be a curve point
    dp, dq = jg.points_to_device(ps), jg.points_to_device(qs)

    def rows(a):
        return [a[i] for i in range(L)]

    want = _k_g1_madd((rows(dp.x), rows(dp.y), rows(dp.z)),
                      (rows(dq.x), rows(dq.y)))
    tp = _tp(dp)
    got = g1_madd64(PointsXYZ(*(c.long() for c in tp)), _t(dq.x).long(),
                    _t(dq.y).long())
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(jnp.stack(w)).astype(
            np.int64))
    assert points_from_device(PointsXYZ(*(c.int() for c in got))) == [
        _host(p.add(q)) for p, q in zip(ps, qs)]


def test_points_roundtrip_and_select():
    ps, _ = _pairs()
    tps = [_host(p) for p in ps]
    dev = points_to_device(tps, "cpu")
    jdev = jg.points_to_device(ps)
    assert all(_eq(a, b) for a, b in zip(dev, jdev))
    assert points_from_device(dev) == tps
    cond = torch.tensor([i % 2 == 0 for i in range(len(ps))])
    sel = g1_select(cond, dev, points_to_device([TG1.infinity()] * len(ps), "cpu"))
    assert points_from_device(sel) == [p if i % 2 == 0 else TG1.infinity()
                                       for i, p in enumerate(tps)]


def _bases_and_plan(t_rows=8, s_pad=96, seed=21):
    rng = StdRng.seed_from_u64(seed)
    pts = [rng.rand_g1() for _ in range(20)] + [G1.infinity()]
    db = jmd.DeviceBases(pts)
    n = db.n
    r = np.random.default_rng(seed)
    # live entries, input infinities (dead) and the 2n sentinel, mixed
    plan = r.integers(0, 2 * n + 1, size=(t_rows, s_pad)).astype(np.int32)
    plan[r.random((t_rows, s_pad)) < 0.3] = 2 * n
    plan[:, 0] = 2 * n
    plan[:, 1] = 20  # the infinity base: dead rows on every step
    return db, plan


def _jax_fold_jnp(ext_px, ext_py, ext_zb, plan):
    """The JAX pipeline's non-Pallas fold branch (msm_device.py:489-498)."""
    one_col = JFQ.const(1, (1,))

    def fold_step(a, row):
        qx = jmd._unpack_rows(jnp.take(ext_px, row, axis=1))
        qy = jmd._unpack_rows(jnp.take(ext_py, row, axis=1))
        zb = jnp.take(ext_zb, row)
        qz = jnp.where(zb[None] != 0, one_col, jnp.uint32(0))
        return jg._g1_add_jnp(a, jg.PointsXYZ(qx, qy, qz)), None

    acc, _ = lax.scan(fold_step, jg.g1_infinity((plan.shape[1],)), plan)
    return acc


def test_plain_fold_matches_jax_fold_branch():
    db, plan = _bases_and_plan()
    want = jax.jit(_jax_fold_jnp)(db.ext_px, db.ext_py, db.ext_zb,
                                  jnp.asarray(plan))
    got = kernels.g1_fold_madd(_t(db.ext_px), _t(db.ext_py), _t(db.ext_zb),
                               torch.from_numpy(plan))
    assert points_from_device(got) == [
        _host(p) for p in jg.points_from_device(want)]


def _jax_suffix_jnp(x, y, z):
    """The JAX pipeline's non-Pallas bucket-reduction branch
    (msm_device.py:543-554)."""
    cb, wg = x.shape[1], x.shape[2]
    dense = jg.PointsXYZ(x, y, z)

    def p3_step(i, st):
        suf, wsum = st
        j = cb - 1 - i
        q = jg.PointsXYZ(
            lax.dynamic_index_in_dim(dense.x, j, 1, keepdims=False),
            lax.dynamic_index_in_dim(dense.y, j, 1, keepdims=False),
            lax.dynamic_index_in_dim(dense.z, j, 1, keepdims=False))
        suf = jg._g1_add_jnp(suf, q)
        return suf, jg._g1_add_jnp(wsum, suf)

    inf = jg.g1_infinity((wg,))
    return lax.fori_loop(0, cb, p3_step, (inf, inf))


def test_plain_suffix_matches_jax_reduction_branch():
    rng = StdRng.seed_from_u64(31)
    cb, wg = 4, 6
    pts = [rng.rand_g1() for _ in range(cb * wg - 3)] + [G1.infinity()] * 3
    d = jg.points_to_device(pts)
    x, y, z = (c.reshape(L, cb, wg) for c in d)
    wt, ww = jax.jit(_jax_suffix_jnp)(x, y, z)
    gt, gw = kernels.g1_suffix_weighted(_t(x), _t(y), _t(z))
    assert all(_eq(a, b) for a, b in zip((*gt, *gw), (*wt, *ww)))
    # and the function it stands for, on the host model
    hp = [_host(p) for p in pts]
    for lane, (tot, wei) in enumerate(zip(points_from_device(gt),
                                          points_from_device(gw))):
        col = [hp[j * wg + lane] for j in range(cb)]
        want_t, want_w = TG1.infinity(), TG1.infinity()
        for j, p in enumerate(col):
            want_t = want_t.add(p)
            want_w = want_w.add(p.mul(j + 1))
        assert (tot, wei) == (want_t, want_w)


@pytest.mark.parametrize("cb, wg", [(8, 4), (16, 3)])
def test_tree_suffix_matches_chain_and_jax_reduction_branch(cb, wg):
    """The tree entry's order of adds (`g1_suffix_weighted_tree_plain`)
    gives the chain's points: affine equality against the plain chain and
    the JAX reduction branch, on lanes with buckets at infinity and P beside
    -P."""
    rng = StdRng.seed_from_u64(32 + cb)
    pts = [rng.rand_g1() for _ in range(cb * wg)]
    for j in range(0, cb, 3):
        pts[j * wg] = G1.infinity()               # lane 0: some empty buckets
    for j in range(1, cb, 2):
        pts[j * wg + 1] = pts[(j - 1) * wg + 1].neg()   # lane 1: P, -P pairs
    d = jg.points_to_device(pts)
    x, y, z = (c.reshape(L, cb, wg) for c in d)
    wt, ww = jax.jit(_jax_suffix_jnp)(x, y, z)
    tt, tw = kernels.g1_suffix_weighted_tree_plain(_t(x), _t(y), _t(z))
    ct, cw = kernels.g1_suffix_weighted_plain(_t(x), _t(y), _t(z))
    for got, chain, ref in ((tt, ct, wt), (tw, cw, ww)):
        assert points_from_device(got) == points_from_device(chain) == [
            _host(p) for p in jg.points_from_device(ref)]
