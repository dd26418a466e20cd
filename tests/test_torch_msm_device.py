"""The port's MSM pipeline (curdleproofs_tpu_torch.ops.msm_device) stage by
stage against the JAX package's `_msm_pipeline(..., pallas=False)` on the
same bases and scalars, run as the JAX package's own tests run it on the CPU
(the shape families of n in {7, 40, 130}, c = 8, that
tests/test_msm_device.py runs).

Tolerances: array equality for signed digits, sorted bucket keys and slot
counts; affine point equality for window sums.  The port sorts with
`torch.sort(stable=True)`, while the reference's `lax.sort` is not asked to
be stable, so entries of one bucket may fold in another order and the
projective window sums may legitimately differ."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from curdleproofs_tpu.constants import R
from curdleproofs_tpu.host.g1 import G1
from curdleproofs_tpu.host.rng import StdRng
from curdleproofs_tpu.host.serde import g1_to_bytes
from curdleproofs_tpu.ops import msm_device as jmd
from curdleproofs_tpu_torch.host.serde import g1_to_bytes as t_g1_to_bytes
from curdleproofs_tpu_torch.ops import msm_device as md

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

rnd = random.Random(17)


def _inputs(n, seed):
    rng = StdRng.seed_from_u64(seed)
    pts = [rng.rand_g1() for _ in range(n)]
    ss = [rnd.randrange(R) for _ in range(n)]
    ss[0], ss[1], ss[-1] = 0, 1, R - 1
    pts[2] = G1.infinity()
    if n > 20:
        pts[5] = pts[6]  # duplicate base
        ss[5] = ss[6]
    return pts, ss


def _jax_sorted_keys(jdigits, c):
    """Stages 3-4 of the reference (msm_device.py:429-435), from its digits."""
    b_cnt = 1 << (c - 1)
    key = jnp.where(jdigits != 0, jnp.abs(jdigits) - 1, b_cnt)
    n = jdigits.shape[1]
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    eidx = jnp.where(jdigits < 0, idx + n, idx) + jnp.zeros_like(key)
    key_s, _ = lax.sort((key, eidx), dimension=1, num_keys=1)
    return np.asarray(key_s)


def _slot_counts(key_s, c, t_rows):
    """Independent oracle: a window's slots are sum_k ceil(count_k / T)."""
    b_cnt = 1 << (c - 1)
    out = []
    for row in key_s:
        counts = np.bincount(row[row < b_cnt], minlength=b_cnt)
        out.append(int(np.sum(-(-counts // t_rows))))
    return out


def _plan_stages(limbs16, n_pad, c):
    """Digits, sorted keys and slot counts from both packages."""
    params = md.pick_params(n_pad, c)
    jd = jmd._signed_digits(jnp.asarray(limbs16), params.n, c)
    td = md._signed_digits(torch.from_numpy(limbs16.astype(np.int32)),
                           params.n, c)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    sp = md._slot_plan(td, n=params.n, c=c, t_rows=params.t_rows,
                       s_pad=params.s_pad)
    jkey = _jax_sorted_keys(jd, c)
    assert np.array_equal(sp.key_s.numpy(), jkey)
    assert sp.slots_per_w.tolist() == _slot_counts(jkey, c, params.t_rows)
    # every live (window, entry) sits in exactly one plan cell
    live = int((jkey < (1 << (c - 1))).sum())
    assert int((sp.plan != 2 * params.n).sum()) == live
    return params, sp


@pytest.mark.parametrize("n", [7, 40, 130])
def test_pipeline_stages_match_jax(n):
    pts, ss = _inputs(n, seed=4 + n)
    jbases = jmd.DeviceBases(pts)
    params = jmd.pick_params(jbases.n, 8)
    assert md.pick_params(n, 8) == md.MsmParams(*(getattr(params, f) for f in
                                                  ("n", "c", "t_rows",
                                                   "s_pad")))
    limbs = jmd._scalars_to_limbs(ss, params.n)
    assert np.array_equal(md._scalars_to_limbs(ss, params.n), limbs)
    _plan_stages(limbs, params.n, 8)

    want = np.asarray(jmd._dispatch_pipeline(jbases, ss, params))
    tbases = md.DeviceBases(
        [md.G1.infinity() if p.is_infinity() else md.G1.from_affine(
            *p.to_affine()) for p in pts], "cpu")
    for a, b in zip((tbases.ext_px, tbases.ext_py, tbases.ext_zb),
                    (jbases.ext_px, jbases.ext_py, jbases.ext_zb)):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b))
    got = md._msm_pipeline(tbases, limbs, md.pick_params(n, 8)).numpy()
    assert got.shape == want.shape == (3, 24, params.windows)
    jw = [g1_to_bytes(p) for p in jmd._window_sums_to_host(want)]
    tw = [t_g1_to_bytes(p) for p in md._window_sums_to_host(got)]
    assert tw == jw


@pytest.mark.parametrize("c", [8, 16])
def test_plan_stages_match_jax_both_windows(c):
    """The digit and plan stages at both window widths (c = 16's end-to-end
    run takes minutes of plain arithmetic on the CPU, so it runs on the card
    in the `cuda` tier)."""
    n = 130
    ss = [rnd.randrange(R) for _ in range(n)] + [0, 1, R - 1, R >> 1]
    n_pad = md.pad_n(len(ss))
    limbs = jmd._scalars_to_limbs(ss, n_pad)
    params, sp = _plan_stages(limbs, n_pad, c)
    assert sp.plan.shape == (params.t_rows, params.s_pad)
    assert sp.kmax >= 1


def test_leave_montgomery_one_product_matches_three_and_jax():
    """Leave-Montgomery as one product over the three coordinates side by
    side ([24, 3W]) equals the three products, one a coordinate, and the
    JAX package's `_leave_montgomery` (array equality)."""
    from curdleproofs_tpu.ops import g1_ops as jg
    from curdleproofs_tpu_torch.ops.field import FQ
    from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ

    rng = StdRng.seed_from_u64(23)
    pts = [rng.rand_g1() for _ in range(5)] + [G1.infinity()]
    d = jg.points_to_device(pts)
    # a general z: every coordinate times one seeded Montgomery factor
    lam = FQ.const(987654321, (1,), "cpu")
    wsum = PointsXYZ(*(FQ.mul(torch.from_numpy(np.asarray(c).astype(
        np.int32)), lam) for c in d))
    one = FQ.plain_const(1, (1,), "cpu")
    three = torch.stack([FQ.mul(c, one) for c in wsum])
    got = md._leave_montgomery(wsum)
    assert got.shape == three.shape and torch.equal(got, three)
    want = jmd._leave_montgomery(jg.PointsXYZ(
        *(jnp.asarray(c.numpy().astype(np.uint32)) for c in wsum)))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
