"""The folds and the batched add of the port, on the CPU, against the JAX
package on the same inputs.

- `g1_fold_packed_plain` (the plain version of the full-add bucket fold
  `g1_fold_packed`, for `g1_fold_rows_packed_pallas`) against the JAX
  pipeline's full-add fold off the TPU, the `lax.scan` of `fold_step`
  (curdleproofs_tpu/ops/msm_device.py:488-498, copied below), on the same
  resident bases and plan;
- `g1_fold_rows` (for `g1_fold_rows_pallas`) against a `lax.scan` of
  `_g1_add_jnp` over the T rows, as the JAX pipeline folds off the TPU
  (curdleproofs_tpu/ops/msm_device.py:491-498);
- `g1_add_rows` (for `g1_add_pallas`) against `_g1_add_jnp`, the function
  `g1_ops.g1_add` runs off the TPU.

Neither TPU kernel runs here: `g1_fold_rows_pallas` takes no `interpret`
argument, and `g1_add_pallas(interpret=True)` is too slow on XLA:CPU.  On
CPU tensors both port wrappers run their plain versions.

Inputs come from numpy with a seed: points k*G with a random z (general
projective representatives), infinities (0 : l : 0), dead rows with z = 0,
P and -P in one column, and one point repeated down a column, so the
complete add doubles.  Tolerance: array equality of the limb arrays (both
sides run the complete add in the same operation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from curdleproofs_tpu.host.g1 import GENERATOR
from curdleproofs_tpu.ops import g1_ops as jg
from curdleproofs_tpu.ops import msm_device as jmd
from curdleproofs_tpu.ops.field import FQ as JFQ
from curdleproofs_tpu_torch.constants import Q
from curdleproofs_tpu_torch.host.g1 import GENERATOR as TGEN
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ, points_from_device
from curdleproofs_tpu_torch.host.g1 import G1 as TG1
from curdleproofs_tpu_torch.ops.limbs import FQ_LIMBS as L
from curdleproofs_tpu_torch.ops.limbs import ints_to_limbs

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

T_ROWS, S_COLS = 8, 512


def _pool(r: np.random.Generator, k: int) -> list[tuple[int, int]]:
    """k affine points k_i * G, k_i drawn from `r`."""
    return [GENERATOR.mul(int(v)).to_affine()
            for v in r.integers(1, 2**62, size=k)]


def _mont_rows(vals: np.ndarray) -> np.ndarray:
    """Python ints mod q, any shape -> [24, *shape] uint32 Montgomery limbs."""
    flat = [FQ.to_mont(int(v)) for v in vals.reshape(-1)]
    return ints_to_limbs(flat, L).T.reshape(L, *vals.shape)


def _rows(seed: int, t_rows: int, s_cols: int):
    """[24, T, S] x3 projective rows with the special columns described in
    the module docstring."""
    r = np.random.default_rng(seed)
    pool = _pool(r, 12)
    pick = r.integers(0, len(pool), size=(t_rows, s_cols))
    lam = np.array([int(v) for v in r.integers(1, 2**63, size=t_rows * s_cols)],
                   dtype=object).reshape(t_rows, s_cols)
    x = np.empty((t_rows, s_cols), dtype=object)
    y = np.empty_like(x)
    z = np.empty_like(x)
    for t in range(t_rows):
        for s in range(s_cols):
            px, py = pool[pick[t, s]]
            x[t, s], y[t, s], z[t, s] = px, py, 1
    kind = r.random((t_rows, s_cols))
    x[kind < 0.1], z[kind < 0.1] = 0, 0                 # infinities (0 : 1 : 0)
    z[(kind >= 0.1) & (kind < 0.2)] = 0                 # dead rows: z = 0
    px, py = pool[0]
    if t_rows > 1:                                      # P, then -P
        x[:2, 1], y[:2, 1], z[:2, 1] = px, [py, (Q - py) % Q], 1
    x[:, 2], y[:, 2], z[:, 2] = px, py, 1               # one point repeated
    x[:, 3], y[:, 3], z[:, 3] = 0, 1, 0                 # a column of infinity
    # a general projective representative: (l x : l y : l z)
    x, y, z = ((a * lam) % Q for a in (x, y, z))
    return tuple(_mont_rows(a) for a in (x, y, z))


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def _eq(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().view(np.uint32), np.asarray(j))


@jax.jit
def _jax_fold_rows(x, y, z):
    """The JAX package's CPU twin of `g1_fold_rows_pallas`: a scan of the
    complete add over the T rows from infinity."""
    def step(acc, row):
        return jg._g1_add_jnp(acc, jg.PointsXYZ(*row)), None

    rows = tuple(jnp.moveaxis(a, 1, 0) for a in (x, y, z))
    acc, _ = lax.scan(step, jg.g1_infinity((x.shape[2],)), rows)
    return acc


def test_fold_rows_matches_jax_scan():
    x, y, z = _rows(41, T_ROWS, S_COLS)
    before = dict(K.LAUNCHES)
    got = K.g1_fold_rows(_torch(x), _torch(y), _torch(z))
    assert K.LAUNCHES == before          # CPU tensors: the plain version
    want = _jax_fold_rows(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    assert all(g.dtype == torch.int32 and g.shape == (L, S_COLS)
               for g in got)
    assert all(_eq(g, w) for g, w in zip(got, want))


def test_fold_rows_sums_the_points():
    """Column 2 (P repeated) and column 3 (only infinities) as points,
    against the host model."""
    x, y, z = _rows(41, T_ROWS, S_COLS)
    got = K.g1_fold_rows(_torch(x[:, :, :4]), _torch(y[:, :, :4]),
                         _torch(z[:, :, :4]))
    pts = points_from_device(got)
    assert pts[3] == TG1.infinity()
    p = TG1.from_affine(*_pool(np.random.default_rng(41), 12)[0])
    assert pts[2] == p.mul(T_ROWS)


def test_fold_rows_one_row_and_ragged_width():
    """T = 1 and S = 37: one complete add onto infinity per column, as the
    JAX scan gives it."""
    x, y, z = _rows(43, 1, 37)
    got = K.g1_fold_rows(_torch(x), _torch(y), _torch(z))
    want = _jax_fold_rows(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    assert all(_eq(g, w) for g, w in zip(got, want))


def test_add_rows_matches_jax_complete_add():
    x, y, z = _rows(47, 2, S_COLS)
    p = tuple(a[:, 0] for a in (x, y, z))
    q = tuple(a[:, 1] for a in (x, y, z))
    q[0][:, 5], q[1][:, 5], q[2][:, 5] = p[0][:, 5], p[1][:, 5], p[2][:, 5]
    before = dict(K.LAUNCHES)
    got = K.g1_add_rows(PointsXYZ(*map(_torch, p)), PointsXYZ(*map(_torch, q)))
    assert K.LAUNCHES == before
    want = jax.jit(jg._g1_add_jnp)(jg.PointsXYZ(*map(jnp.asarray, p)),
                                   jg.PointsXYZ(*map(jnp.asarray, q)))
    assert all(_eq(g, w) for g, w in zip(got, want))
    assert all(_eq(g, w) for g, w in zip(
        K.g1_add_rows_plain(PointsXYZ(*map(_torch, p)),
                            PointsXYZ(*map(_torch, q))), want))


@jax.jit
def _jax_fold_packed(ext_px, ext_py, ext_zb, plan):
    """The JAX pipeline's full-add fold off the TPU (`fold_step` of
    curdleproofs_tpu/ops/msm_device.py:488-498): the complete add of every
    row of the plan, z rebuilt from the liveness bit."""
    one_col = JFQ.const(1, (1,))

    def fold_step(a, row):
        qx = jmd._unpack_rows(jnp.take(ext_px, row, axis=1))
        qy = jmd._unpack_rows(jnp.take(ext_py, row, axis=1))
        zb = jnp.take(ext_zb, row)
        qz = jnp.where(zb[None] != 0, one_col, jnp.uint32(0))
        return jg._g1_add_jnp(a, jg.PointsXYZ(qx, qy, qz)), None

    acc, _ = lax.scan(fold_step, jg.g1_infinity((plan.shape[1],)), plan)
    return acc


def test_fold_packed_plain_matches_jax_full_add_fold():
    """On resident bases of 40 points (two of them infinity) and a [8, 70]
    plan: live rows, input infinities and their negations, the sentinel,
    an all-dead slot, one base 8 times, P then -P, dead rows inside live
    prefixes and a ragged width."""
    r = np.random.default_rng(53)
    pts = [TGEN.mul(int(k)) for k in r.integers(1, 2**62, size=40)]
    pts[6] = pts[13] = TG1.infinity()
    b = md.DeviceBases(pts, "cpu")
    n = b.n
    plan = r.integers(0, 2 * n + 1, size=(T_ROWS, 70))
    lengths = r.integers(0, T_ROWS + 1, size=70)
    plan[np.arange(T_ROWS)[:, None] >= lengths[None, :]] = 2 * n
    plan[r.random(plan.shape) < 0.05] = 2 * n
    plan[:, 0] = 2 * n
    plan[:, 1] = 5
    plan[:, 2] = [7, 7 + n] * (T_ROWS // 2)
    plan[:, 3] = [6, 6 + n, 13 + n, 9] * (T_ROWS // 4)
    plan = torch.from_numpy(plan.astype(np.int32))
    ext = (b.ext_px, b.ext_py, b.ext_zb)
    got = K.g1_fold_packed_plain(*ext, plan)
    want = _jax_fold_packed(*(jnp.asarray(t.numpy().view(np.uint32))
                              for t in ext), jnp.asarray(plan.numpy()))
    assert all(_eq(g, w) for g, w in zip(got, want))
