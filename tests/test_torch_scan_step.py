"""The masked suffix scan of the port's MSM pipeline (`msm_device.
_suffix_scan`, one `g1_add_scan` round a stride) on the CPU, against the JAX
package's two scan sites on the same inputs:
- the slot merge (curdleproofs_tpu/ops/msm_device.py:502-521): a
  `lax.while_loop` of the complete add, the partner gathered with
  `jnp.take`, kept where its slot key equals the lane's;
- `suffix_over_g` (:567-579): the same rounds within each window's G
  chunks, masked by `(g mod G) + stride < G`, which the port writes as the
  key `g // G`.

On CPU tensors `g1_add_scan` runs its plain version (the torch expression
both sites used before the step was fused), so these hold the plain path the
card's kernel is compared with.  Widths are ragged (37 and 48 lanes); the
cases cover runs of every length up to the span, keys that change at every
lane (nothing merges), and a span past the width (strides >= n).  Inputs come
from numpy with a seed: points k*G in a general projective representative,
infinities (0 : l : 0) and all-zero (0, 0, 0) rows.  Tolerance: array
equality (both sides run the complete add in the same operation order).

Both loops are closures inside the JAX pipeline, so the helpers below copy
them (only the add, `_g1_add_jnp`, comes from the package).  If the
reference's loops change, these copies do not follow: the end-to-end checks
of the whole pipeline against the JAX package stay in
`tests/test_torch_msm_device.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from curdleproofs_tpu.host.g1 import GENERATOR
from curdleproofs_tpu.ops import g1_ops as jg
from curdleproofs_tpu_torch.constants import Q
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops.field import FQ
from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ
from curdleproofs_tpu_torch.ops.limbs import FQ_LIMBS as L
from curdleproofs_tpu_torch.ops.limbs import ints_to_limbs

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


def _points(seed: int, n: int) -> tuple[np.ndarray, ...]:
    """[24, n] x3 uint32 Montgomery limbs: k*G scaled by a random l, with
    infinities in every 7th lane and all-zero rows in every 11th."""
    r = np.random.default_rng(seed)
    pool = [GENERATOR.mul(int(k)).to_affine()
            for k in r.integers(1, 2**62, size=9)]
    lam = [int(v) for v in r.integers(1, 2**63, size=n)]
    cols = []
    for i in range(n):
        x, y = pool[int(r.integers(0, len(pool)))]
        p = (0, 0, 0) if i % 11 == 5 else (0, 1, 0) if i % 7 == 3 else \
            (x, y, 1)
        cols.append([c * lam[i] % Q for c in p])
    return tuple(ints_to_limbs([FQ.to_mont(c[k]) for c in cols], L).T
                 .astype(np.uint32) for k in range(3))


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _eq(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().view(np.uint32), np.asarray(j))


@jax.jit
def _jax_merge(x, y, z, key, kmax):
    """The reference's slot merge, with the slot keys `key`: a copy of
    curdleproofs_tpu/ops/msm_device.py:502-521 (`mbody` and its
    `lax.while_loop`), the add taken as `_g1_add_jnp`."""
    n = key.shape[0]
    sidx = jnp.arange(n, dtype=jnp.int32)

    def mbody(st):
        stride, ax, ay, az = st
        partner = jnp.minimum(sidx + stride, n - 1)
        same = (jnp.take(key, partner) == key) & (sidx + stride < n)
        q = jg.PointsXYZ(*(jnp.take(a, partner, axis=1)
                           for a in (ax, ay, az)))
        s = jg._g1_add_jnp(jg.PointsXYZ(ax, ay, az), q)
        return (stride * 2, *(jnp.where(same[None], a, b)
                               for a, b in zip(s, (ax, ay, az))))

    _, mx, my, mz = lax.while_loop(lambda st: st[0] < kmax, mbody,
                                   (jnp.int32(1), x, y, z))
    return mx, my, mz


@jax.jit
def _jax_suffix_over_g(x, y, z, g_chunks):
    """The reference's `suffix_over_g` over W windows of G chunks: a copy
    of curdleproofs_tpu/ops/msm_device.py:567-579 (its Python loop over
    strides as a `lax.while_loop`), the add taken as `_g1_add_jnp`."""
    wg = x.shape[1]
    wgidx = jnp.arange(wg, dtype=jnp.int32)
    gpos = wgidx % g_chunks

    def body(st):
        stride, vx, vy, vz = st
        partner = jnp.minimum(wgidx + stride, wg - 1)
        mask = (gpos + stride < g_chunks)[None]
        q = jg.PointsXYZ(*(jnp.take(a, partner, axis=1)
                           for a in (vx, vy, vz)))
        s = jg._g1_add_jnp(jg.PointsXYZ(vx, vy, vz), q)
        return (stride * 2, *(jnp.where(mask, a, b)
                              for a, b in zip(s, (vx, vy, vz))))

    _, ux, uy, uz = lax.while_loop(lambda st: st[0] < g_chunks, body,
                                   (jnp.int32(1), x, y, z))
    return ux, uy, uz


def _runs(seed: int, n: int, longest: int) -> np.ndarray:
    """Sorted slot keys in runs of 1..longest lanes (a run of `longest`
    first, so the span is reached)."""
    r = np.random.default_rng(seed)
    lengths = [longest]
    while sum(lengths) < n:
        lengths.append(int(r.integers(1, longest + 1)))
    return np.repeat(np.arange(len(lengths)) * 3 + 2, lengths)[:n]


N = 37
MERGE_CASES = {
    # runs of every length up to kmax = 6: rounds at strides 1, 2, 4
    "runs": (_runs(1, N, 6), 6),
    # a new key at every lane: no lane merges, whatever the span
    "distinct": (np.arange(N) * 5, 8),
    # one run over every lane, span past the width: strides 32 and 64 >= n
    "span_past_width": (np.zeros(N, dtype=np.int64), 128),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_scan_matches_jax(case):
    key, kmax = MERGE_CASES[case]
    x, y, z = _points(7, N)
    before = dict(K.LAUNCHES)
    got = md._suffix_scan(PointsXYZ(_torch(x), _torch(y), _torch(z)),
                          torch.from_numpy(key.astype(np.int64)), kmax)
    assert K.LAUNCHES == before          # CPU tensors: the plain version
    want = _jax_merge(*map(jnp.asarray, (x, y, z)),
                      jnp.asarray(key.astype(np.int32)), kmax)
    assert all(g.dtype == torch.int32 and g.shape == (L, N) for g in got)
    assert all(_eq(g, w) for g, w in zip(got, want))
    if case == "distinct":
        assert all(_eq(g, w) for g, w in zip(got, (x, y, z)))


@pytest.mark.parametrize("w_cnt, g_chunks", [(3, 16), (12, 4)])
def test_suffix_over_g_matches_jax(w_cnt, g_chunks):
    wg = w_cnt * g_chunks
    x, y, z = _points(11 + g_chunks, wg)
    key = torch.arange(wg) // g_chunks
    got = md._suffix_scan(PointsXYZ(_torch(x), _torch(y), _torch(z)), key,
                          g_chunks)
    want = _jax_suffix_over_g(*map(jnp.asarray, (x, y, z)), g_chunks)
    assert all(_eq(g, w) for g, w in zip(got, want))
