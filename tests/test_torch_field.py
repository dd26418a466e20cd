"""Port field arithmetic (curdleproofs_tpu_torch.ops.field) against the JAX
package's `ops.field.FQ` and host ints, on the same inputs.

Residues are exact integers in the same Montgomery radix (R = 2^384) in both
packages, so the tolerance is array equality of the limb arrays."""

import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from curdleproofs_tpu.constants import Q
from curdleproofs_tpu.ops.field import FQ as JFQ
from curdleproofs_tpu.ops.limbs import FQ_LIMBS, ints_to_limbs, limbs_to_ints
from curdleproofs_tpu_torch.ops import kernels
from curdleproofs_tpu_torch.ops.field import FQ, cond_sub_rows, mul_rows

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

rnd = random.Random(4321)

j_add = jax.jit(JFQ.add)
j_sub = jax.jit(JFQ.sub)
j_neg = jax.jit(JFQ.neg)
j_mul = jax.jit(JFQ.mul)
j_mul12 = jax.jit(lambda a: JFQ.mul_const(a, 12))


def _vals(n):
    return [0, 1, Q - 1, Q - 2, Q // 2] + [rnd.randrange(Q)
                                           for _ in range(n - 5)]


def _limbs(vals):
    """Montgomery limbs [24, B] as numpy uint32 (fed to both packages)."""
    return ints_to_limbs([JFQ.to_mont(v) for v in vals], FQ_LIMBS).T.copy()


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _host(a):
    return [FQ.from_mont(v) for v in limbs_to_ints(np.asarray(a).T)]


def test_fq_ops_match_jax_and_host():
    n = 48
    a, b = _vals(n), list(reversed(_vals(n)))
    na, nb = _limbs(a), _limbs(b)
    ja, jb = jnp.asarray(na), jnp.asarray(nb)
    ta, tb = _t(na), _t(nb)
    cases = [
        (FQ.add(ta, tb), j_add(ja, jb), [(x + y) % Q for x, y in zip(a, b)]),
        (FQ.sub(ta, tb), j_sub(ja, jb), [(x - y) % Q for x, y in zip(a, b)]),
        (FQ.neg(ta), j_neg(ja), [(Q - x) % Q for x in a]),
        (FQ.mul(ta, tb), j_mul(ja, jb), [x * y % Q for x, y in zip(a, b)]),
        (FQ.mul_const(ta, 12), j_mul12(ja), [x * 12 % Q for x in a]),
    ]
    for got, want, host in cases:
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
        assert _host(got.numpy()) == host


def test_mul_rows_stress_and_broadcast():
    n = 512
    a = [rnd.randrange(Q) for _ in range(n)]
    b = [rnd.randrange(Q) for _ in range(n)]
    na, nb = _limbs(a), _limbs(b)
    got = mul_rows(_t(na).long(), _t(nb).long(), Q, FQ.n0_inv)
    want = np.asarray(j_mul(jnp.asarray(na), jnp.asarray(nb)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # one column against a batch: the multiply broadcasts like the reference
    col = _t(na[:, :1]).long()
    got = mul_rows(col, _t(nb).long(), Q, FQ.n0_inv)
    assert _host(got.numpy()) == [a[0] * y % Q for y in b]


def test_cond_sub_rows_canonicalises():
    vals = [0, 1, Q - 1, Q, Q + 1, 2 * Q - 1] + [rnd.randrange(2 * Q)
                                                  for _ in range(26)]
    rows = torch.from_numpy(
        ints_to_limbs(vals, FQ_LIMBS).T.astype(np.int64))
    got = cond_sub_rows(rows, Q)
    assert limbs_to_ints(got.numpy().T) == [v % Q for v in vals]


def test_const_select_and_infinity_rows():
    one = FQ.const(1, (3,), "cpu")
    assert _host(one.numpy()) == [1, 1, 1]
    z = FQ.zeros((3,), "cpu")
    sel = FQ.select(torch.tensor([True, False, True]), one, z)
    assert _host(sel.numpy()) == [1, 0, 1]


def test_cuda_header_constants_match_field():
    """The kernels' field core hard-codes q, R mod q and -q^-1 mod 2^32 in
    32-bit limbs (`q_limb`, `one_limb`, `N0` of fq_cc.cuh); they must be
    this field's."""
    src = (kernels.CSRC / "fq_cc.cuh").read_text()

    def limbs(name):
        body = re.search(r"constexpr uint32_t " + name + r"\(int i\) \{(.*?)\}",
                         src, re.S).group(1)
        words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", body)]
        assert len(words) == 12
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert limbs("q_limb") == Q
    assert limbs("one_limb") == FQ.one_mont
    n0 = int(re.search(r"N0 = (0x[0-9a-f]+)u", src).group(1), 16)
    assert n0 == (-pow(Q, -1, 1 << 32)) % (1 << 32)
