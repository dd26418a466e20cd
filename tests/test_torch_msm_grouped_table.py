"""The port's grouped MSM, table mode (curdleproofs_tpu_torch.ops.msm_grouped)
against the JAX package's with `pallas=False`, run as the JAX package's own
tests run it on the CPU: a pool of 60 points from `StdRng.seed_from_u64(7)`
(its residency padded to N = 64 with infinities, so the table holds dead
columns too, and relations address them) and 8 relations of widths 3..24.

- `DeviceBasesTable`'s residency `ext_px, ext_py, ext_zb` ([d*P | -d*P |
  inf], 16N + 1 entries) is array-equal to the JAX package's: the seven
  complete adds, the z-product, the host inversion, the prefix and suffix
  products of `fq_mul` (the reference's `associative_scan`s) and the
  negations;
- the table-mode output [3, 24, n_rel] with `madd=False` is array-equal to
  `_grouped_table_jit(..., pallas=False, madd=False)`; with `madd=True`
  the decoded points are equal, and equal to the port's host MSM.

Tolerance: exact (array equality of limbs, point equality)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.host.rng import StdRng as JRng
from curdleproofs_tpu.ops import msm_device as jmd
from curdleproofs_tpu.ops import msm_grouped as jg
from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import R
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops import msm_grouped as tg

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    """The pool, and its table residency in both packages."""
    rng = StdRng.seed_from_u64(7)
    pool = [rng.rand_g1() for _ in range(60)]
    jrng = JRng.seed_from_u64(7)
    jt = jg.DeviceBasesTable(jmd.DeviceBases(
        [jrng.rand_g1() for _ in range(60)]))
    tt = tg.DeviceBasesTable(md.DeviceBases(pool, "cpu"))
    return pool, jt, tt


def test_table_residency_matches_jax(tables):
    _, jt, tt = tables
    assert tt.n == jt.n == 64 and tt.n_real == 60
    assert tt.ext_px.shape == (12, 16 * 64 + 1)
    for a, b in zip((tt.ext_px, tt.ext_py, tt.ext_zb),
                    (jt.ext_px, jt.ext_py, jt.ext_zb)):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b))


def test_table_output_matches_jax(tables):
    pool, jt, tt = tables
    rnd = random.Random(9)
    rels = []
    for _ in range(8):
        w = rnd.randrange(3, 25)
        rels.append((rnd.sample(range(64), w),   # 60..63: padding bases
                     [rnd.randrange(R) for _ in range(w)]))
    rels[1] = (rels[1][0], [R - 1 - s % 1000 for s in rels[1][1]])
    rels[2] = ([4] * 10, [8] * 10)
    width = max(len(c) for c, _ in rels)
    limbs, cols = tg.pack_relations(rels, 8, width, tt.n)
    want = np.asarray(jg._grouped_table_jit(
        jt.ext_px, jt.ext_py, jt.ext_zb, jnp.asarray(limbs),
        jnp.asarray(cols), n_rel=8, width=width, n_base=jt.n, pallas=False,
        madd=False))
    lt = torch.from_numpy(limbs.astype(np.int32))
    ct = torch.from_numpy(cols)
    got = tg.grouped_table_run(tt.ext_px, tt.ext_py, tt.ext_zb, lt, ct,
                               n_rel=8, width=width, n_base=tt.n, madd=False)
    assert got.shape == want.shape == (3, 24, 8)
    assert np.array_equal(got.numpy().view(np.uint32), want)

    padded = pool + [md.G1.infinity()] * 4
    host = [HostBackend().msm([padded[c] for c in cc], ss)
            for cc, ss in rels]
    madd = tg.grouped_table_run(tt.ext_px, tt.ext_py, tt.ext_zb, lt, ct,
                                n_rel=8, width=width, n_base=tt.n, madd=True)
    assert tg.decode_points(madd.numpy()) == tg.decode_points(want) == host
