"""The port's grouped MSM, slot mode (curdleproofs_tpu_torch.ops.msm_grouped)
against the JAX package's `ops/msm_grouped.py` with `pallas=False`, run as
the JAX package's own tests run it on the CPU, at one fixed small shape: a
pool of 64 points from `StdRng.seed_from_u64(7)`, 8 relations of widths
3..24 over it.

- `signed_digits_c4` and `pick_grouped_params` equal the JAX package's;
- the grouped output [3, 24, n_rel] with `madd=False` is array-equal to
  `_grouped_msm_jit(..., pallas=False, madd=False)`, and its full-add fold
  equals the JAX package's jnp fold (`grouped_core`'s `lax.scan`) slot for
  slot on the same plan;
- with `madd=True` (the mixed-add fold) the decoded points are equal;
- the four tests of tests/test_msm_grouped.py, held against the port's
  host MSM: random relations, edge scalars, single and empty relations,
  and table mode on adversarial digits.

Tolerance: exact (array equality of limbs, point equality)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from curdleproofs_tpu.host.rng import StdRng as JRng
from curdleproofs_tpu.ops import msm_device as jmd
from curdleproofs_tpu.ops import msm_grouped as jg
from curdleproofs_tpu.ops.field import FQ as JFQ
from curdleproofs_tpu.ops.g1_ops import PointsXYZ as JPoints
from curdleproofs_tpu.ops.g1_ops import _g1_add_jnp
from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import R
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops import msm_grouped as tg

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    rng = StdRng.seed_from_u64(7)
    return [rng.rand_g1() for _ in range(64)]


@pytest.fixture(scope="module")
def bases(pool):
    """The pool resident in both packages (array-equal layouts)."""
    jrng = JRng.seed_from_u64(7)
    jb = jmd.DeviceBases([jrng.rand_g1() for _ in range(64)])
    tb = md.DeviceBases(pool, "cpu")
    for a, b in zip((tb.ext_px, tb.ext_py, tb.ext_zb),
                    (jb.ext_px, jb.ext_py, jb.ext_zb)):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b))
    return jb, tb


def _host(points, scalars):
    return HostBackend().msm(points, scalars)


def test_digits_and_params_match_jax():
    rnd = random.Random(11)
    nib8 = int("8" * 63, 16)                 # every window at half
    ss = [rnd.randrange(R) for _ in range(120)] + [
        0, 1, 8, 9, R - 1, (1 << 252) + 7, nib8 % R, (nib8 + 1) % R,
        (nib8 << 4 | 9) % R, int("8" * 30 + "9" * 33, 16) % R]
    limbs = md._scalars_to_limbs(ss, len(ss))
    want = np.asarray(jg.signed_digits_c4(jnp.asarray(limbs), len(ss)))
    got = tg.signed_digits_c4(torch.from_numpy(limbs.astype(np.int32)),
                              len(ss))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    for args in ((1, 1, 64), (5, 8, 64), (8, 9, 64), (13, 64, 128),
                 (1536, 129, 262144)):
        j = jg.pick_grouped_params(*args)
        assert tg.pick_grouped_params(*args) == tg.GroupedParams(
            j.n_rel, j.width, j.s_pad, j.n_ext)


@pytest.fixture(scope="module")
def slot_case(bases):
    """8 relations of widths 3..24 (negative-heavy, dead and repeated
    columns among them), the JAX output, and the port's madd=False run with
    its fold's plan and output recorded."""
    jb, tb = bases
    rnd = random.Random(3)
    rels = []
    for i in range(8):
        w = rnd.randrange(3, 25)
        rels.append((rnd.sample(range(64), w),
                     [rnd.randrange(R) for _ in range(w)]))
    rels[1] = (rels[1][0], [R - 1 - s % 1000 for s in rels[1][1]])
    rels[2] = (rels[2][0], [0] * len(rels[2][0]))
    rels[3] = ([5] * 9, [rnd.randrange(R) for _ in range(9)])
    width = max(len(c) for c, _ in rels)
    params = tg.pick_grouped_params(len(rels), width, tb.n)
    limbs, cols = tg.pack_relations(rels, params.n_rel, width, tb.n)
    want = np.asarray(jg._grouped_msm_jit(
        jb.ext_px, jb.ext_py, jb.ext_zb, jnp.asarray(limbs),
        jnp.asarray(cols), n_rel=params.n_rel, width=width,
        s_pad=params.s_pad, n_ext=params.n_ext, pallas=False, madd=False))

    folds = []
    fold = tg.g1_fold_packed

    def recording(*args):
        out = fold(*args)
        folds.append((args[3], out))
        return out

    lt = torch.from_numpy(limbs.astype(np.int32))
    ct = torch.from_numpy(cols)
    tg.g1_fold_packed = recording
    try:
        got = tg.grouped_slot_run(tb.ext_px, tb.ext_py, tb.ext_zb, lt, ct,
                                  params=params, madd=False)
    finally:
        tg.g1_fold_packed = fold
    assert len(folds) == 1
    return rels, params, lt, ct, want, got, folds[0]


def test_slot_output_matches_jax_full_add(slot_case, pool):
    rels, params, _, _, want, got, _ = slot_case
    assert got.shape == want.shape == (3, 24, params.n_rel)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    pts = tg.decode_points(got.numpy())
    assert pts[: len(rels)] == [_host([pool[c] for c in cc], ss)
                                for cc, ss in rels]


def test_full_add_fold_matches_jax_jnp_fold(slot_case, bases):
    """The full-add fold on the port's plan against the JAX package's jnp
    fold (the body of `grouped_core`'s `pallas=False` branch,
    curdleproofs_tpu/ops/msm_grouped.py:175-186) on that plan, slot for
    slot."""
    jb, _ = bases
    *_, (plan, acc) = slot_case
    one_col = JFQ.const(1, (1,))

    def fold_step(a, row):
        qx = jmd._unpack_rows(jnp.take(jb.ext_px, row, axis=1))
        qy = jmd._unpack_rows(jnp.take(jb.ext_py, row, axis=1))
        zb = jnp.take(jb.ext_zb, row)
        qz = jnp.where(zb[None] != 0, one_col, jnp.uint32(0))
        return _g1_add_jnp(a, JPoints(qx, qy, qz)), None

    s_pad = plan.shape[1]
    inf = JPoints(JFQ.zeros((s_pad,)), JFQ.const(1, (s_pad,)),
                  JFQ.zeros((s_pad,)))
    want, _ = lax.scan(fold_step, inf, jnp.asarray(plan.numpy()))
    for a, b in zip(acc, want):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b))


def test_slot_madd_decodes_equal(slot_case, bases):
    _, tb = bases
    _, params, lt, ct, want, _, _ = slot_case
    got = tg.grouped_slot_run(tb.ext_px, tb.ext_py, tb.ext_zb, lt, ct,
                              params=params, madd=True)
    assert tg.decode_points(got.numpy()) == tg.decode_points(want)


# --------------------------------------------------------------------------
# tests/test_msm_grouped.py, against the port's host MSM
# --------------------------------------------------------------------------

def test_grouped_matches_host(pool, bases):
    _, tb = bases
    rnd = random.Random(3)
    rels = []
    for _ in range(5):
        w = rnd.randrange(3, len(pool))
        rels.append((rnd.sample(range(len(pool)), w),
                     [rnd.randrange(R) for _ in range(w)]))
    got = tg.grouped_msm(tb, rels)
    for (cols, ss), g in zip(rels, got):
        assert g == _host([pool[c] for c in cols], ss)


def test_grouped_edge_scalars(pool, bases):
    _, tb = bases
    n = 8
    cols = list(range(n))
    rels = [
        (cols, [0] * n),                      # all-zero -> infinity
        (cols, [1] * n),                      # plain sum
        (cols, [R - 1] * n),                  # -1 everywhere (negatives path)
        (cols, [8] * n),                      # digit exactly at half (8)
        (cols, [(1 << 252) + 7] * n),         # top-window + carry absorption
        ([3] * n, [5] * n),                   # repeated base in one relation
    ]
    got = tg.grouped_msm(tb, rels)
    for (cc, ss), g in zip(rels, got):
        assert g == _host([pool[c] for c in cc], ss)


def test_grouped_single_and_empty_relations(pool, bases):
    _, tb = bases
    got = tg.grouped_msm(tb, [([0], [12345]), ([1, 2], [1, R - 2])])
    assert got[0] == pool[0].mul(12345)
    assert got[1] == pool[1].add(pool[2].mul(R - 2))
    assert tg.grouped_msm(tb, []) == []
    with pytest.raises(ValueError, match="columns"):
        tg.grouped_msm(tb, [([0, 1], [5])])
    with pytest.raises(ValueError, match="outside the 64 resident bases"):
        tg.grouped_msm(tb, [([0, 64], [5, 6])])


def test_table_mode_matches_host(pool, bases):
    """Dense table path (precomputed d*P multiples, streaming fold) on the
    slot path's adversarial shapes: negatives, repeats, top-window carries
    and the d = 8 table edge."""
    _, tb = bases
    rnd = random.Random(5)
    table = tg.DeviceBasesTable(tb)
    n = 12
    cols = list(range(n))
    rels = [
        (cols, [rnd.randrange(R) for _ in range(n)]),
        (cols, [0] * n),
        (cols, [R - 1] * n),                  # negatives everywhere
        (cols, [8] * n),                      # digit exactly 8 (max multiple)
        (cols, [(1 << 252) + 7] * n),         # top-window carry
        ([3] * n, [5] * n),                   # repeated base (P+P inside fold)
        ([7], [1 << 254]),                    # short relation + padding
    ]
    got = tg.grouped_msm_table(table, rels)
    for (cc, ss), g in zip(rels, got):
        assert g == _host([pool[c] for c in cc], ss)
    assert tg.grouped_msm_table(table, []) == []
