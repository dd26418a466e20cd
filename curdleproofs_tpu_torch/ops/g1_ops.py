"""Batched BLS12-381 G1 ops: branch-free complete projective formulas (torch).

Points are (X, Y, Z) homogeneous-projective limb-major tensors [24, *batch]
(int32 lanes of 16-bit limbs) in Montgomery form; infinity is (0 : 1 : 0).
The complete formulas (Renes-Costello-Batina 2016, algorithms 7/8/9 for
a = 0) have no exceptional cases, so they vectorise with no control flow.

`g1_add` launches the `g1_add` CUDA kernel for points on the card
(ops/kernels.py); `g1_add64`/`g1_madd64`/`g1_double64` are the plain int64
formulas that the kernels' plain versions run.  Each follows the JAX
package's operation sequence (`_k_g1_add`, `_k_g1_madd`, `g1_double`), so
all give the same projective representatives as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import CURVE_B, Q
from ..host.field import batch_inversion
from ..host.g1 import G1
from .device import resolve_device
from .field import FQ
from .limbs import FQ_LIMBS, ints_to_limbs, limbs_to_ints

__all__ = ["PointsXYZ", "g1_add", "g1_add64", "g1_madd64", "g1_double",
           "g1_double64", "g1_select", "g1_infinity", "g1_infinity64",
           "points_to_device", "points_from_device"]

_B3 = 3 * CURVE_B  # 12


class PointsXYZ(NamedTuple):
    """A batch of projective points; each field is a [24, *batch] tensor."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def g1_infinity(batch_shape=(), device="cuda") -> PointsXYZ:
    return PointsXYZ(
        x=FQ.zeros(batch_shape, device),
        y=FQ.const(1, batch_shape, device),
        z=FQ.zeros(batch_shape, device),
    )


def g1_infinity64(batch_shape=(), device="cuda") -> PointsXYZ:
    return PointsXYZ(*(c.long() for c in g1_infinity(batch_shape, device)))


# --- plain int64 formulas (the kernels' plain versions) -----------------------

def _st(*rows: torch.Tensor) -> torch.Tensor:
    """Stack field elements [24, *b] along a new batch axis -> [24, k, *b], so
    independent field ops of one formula run as one op."""
    return torch.stack(torch.broadcast_tensors(*rows), dim=1)


def g1_add64(p: PointsXYZ, q: PointsXYZ) -> PointsXYZ:
    """Complete addition, a = 0 (RCB16 algorithm 7) on int64 limbs: the
    sequence of `_k_g1_add`, with its independent field ops stacked (each
    op's result is the same canonical residue).  Handles P = Q, P = -Q and
    infinity."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    mul, add, sub, b3 = FQ.mul64, FQ.add64, FQ.sub64, FQ.mul_b3_64

    s1 = add(_st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2))
    m = mul(_st(X1, Y1, Z1, s1[:, 0], s1[:, 1], s1[:, 2]),
            _st(X2, Y2, Z2, s1[:, 3], s1[:, 4], s1[:, 5]))
    t0, t1, t2 = m[:, 0], m[:, 1], m[:, 2]
    # t3 = (X1+Y1)(X2+Y2) - (t0+t1); t4 = (Y1+Z1)(Y2+Z2) - (t1+t2);
    # Y3 = (X1+Z1)(X2+Z2) - (t0+t2)
    d = sub(m[:, 3:6], add(_st(t0, t1, t0), _st(t1, t2, t2)))
    t3, t4 = d[:, 0], d[:, 1]
    t0 = add(add(t0, t0), t0)
    b = b3(_st(t2, d[:, 2]))           # 3b*t2, 3b*Y3
    t2, Y3 = b[:, 0], b[:, 1]
    Z3, t1 = add(t1, t2), sub(t1, t2)
    m = mul(_st(t3, t4, Y3, t1, Z3, t0), _st(t1, Y3, t0, Z3, t4, t3))
    X3 = sub(m[:, 0], m[:, 1])
    yz = add(m[:, 2:6:2], m[:, 3:6:2])
    return PointsXYZ(X3, yz[:, 0], yz[:, 1])


def g1_madd64(p: PointsXYZ, x2: torch.Tensor, y2: torch.Tensor) -> PointsXYZ:
    """Complete mixed addition P + (x2, y2), the second point affine (RCB16
    algorithm 8, a = 0; 11 multiplies): the sequence of `_k_g1_madd`, with
    its independent field ops stacked.  Complete in P; (x2, y2) must be a
    curve point (callers keep the accumulator on dead lanes)."""
    X1, Y1, Z1 = p
    mul, add, sub, b3 = FQ.mul64, FQ.add64, FQ.sub64, FQ.mul_b3_64

    s1 = add(_st(x2, X1), _st(y2, Y1))
    m = mul(_st(X1, Y1, s1[:, 0], y2, x2), _st(x2, y2, s1[:, 1], Z1, Z1))
    t0, t1 = m[:, 0], m[:, 1]
    t3 = sub(m[:, 2], add(t0, t1))     # X1*Y2 + X2*Y1
    ty = add(m[:, 3:5], _st(Y1, X1))   # Y2*Z1 + Y1, X2*Z1 + X1
    t4 = ty[:, 0]
    t0 = add(add(t0, t0), t0)          # 3*X1*X2
    b = b3(_st(Z1, ty[:, 1]))          # 3b*Z1, 3b*Y3
    t2, Y3 = b[:, 0], b[:, 1]
    Z3, t1 = add(t1, t2), sub(t1, t2)
    m = mul(_st(t3, t4, Y3, t1, Z3, t0), _st(t1, Y3, t0, Z3, t4, t3))
    X3 = sub(m[:, 0], m[:, 1])
    yz = add(m[:, 2:6:2], m[:, 3:6:2])
    return PointsXYZ(X3, yz[:, 0], yz[:, 1])


def g1_double64(p: PointsXYZ) -> PointsXYZ:
    """Complete doubling, a = 0 (RCB16 algorithm 9) on int64 limbs: the
    sequence of `g1_double`, with its independent field ops stacked (each
    op's result is the same canonical residue; 3b * t2 by four adds, as
    the adds do it)."""
    X, Y, Z = p
    mul, add, sub = FQ.mul64, FQ.add64, FQ.sub64

    m = mul(_st(Y, Y, Z, X), _st(Y, Z, Z, Y))
    t0, t1, xy = m[:, 0], m[:, 1], m[:, 3]
    # 3b * Z^2 = 8 Z^2 + 4 Z^2 beside Z3 = 8 t0, by the same doublings
    d2 = add(_st(m[:, 2], t0), _st(m[:, 2], t0))
    d4 = add(d2, d2)
    d8 = add(d4, d4)
    t2, z3 = add(d8[:, 0], d4[:, 0]), d8[:, 1]
    m = mul(_st(t2, t1), _st(z3, z3))
    s = add(_st(t0, t2), _st(t2, t2))          # Y3 = t0 + t2, 2 t2
    y3 = s[:, 0]
    t0 = sub(t0, add(s[:, 1], t2))
    m2 = mul(_st(t0, t0), _st(y3, xy))
    x3y3 = add(_st(m2[:, 1], m[:, 0]), _st(m2[:, 1], m2[:, 0]))
    return PointsXYZ(x3y3[:, 0], x3y3[:, 1], m[:, 1])


# --- int32 point ops -----------------------------------------------------------

def g1_add(p: PointsXYZ, q: PointsXYZ) -> PointsXYZ:
    """Complete add; the `g1_add` CUDA kernel for points on the card."""
    from .kernels import g1_add as _kernel

    return _kernel(p, q)


def g1_double(p: PointsXYZ) -> PointsXYZ:
    """Complete doubling, a = 0 (RCB16 algorithm 9)."""
    X, Y, Z = p
    mul, add, sub, mc = FQ.mul, FQ.add, FQ.sub, FQ.mul_const

    t0 = mul(Y, Y)
    Z3 = add(t0, t0)
    Z3 = add(Z3, Z3)
    Z3 = add(Z3, Z3)
    t1 = mul(Y, Z)
    t2 = mul(Z, Z)
    t2 = mc(t2, _B3)
    X3 = mul(t2, Z3)
    Y3 = add(t0, t2)
    Z3 = mul(t1, Z3)
    t1 = add(t2, t2)
    t2 = add(t1, t2)
    t0 = sub(t0, t2)
    Y3 = mul(t0, Y3)
    Y3 = add(X3, Y3)
    t1 = mul(X, Y)
    X3 = mul(t0, t1)
    X3 = add(X3, X3)
    return PointsXYZ(X3, Y3, Z3)


def g1_select(cond, p: PointsXYZ, q: PointsXYZ) -> PointsXYZ:
    """Per-point select: cond has batch shape (no limb axis)."""
    c = cond[None]
    return PointsXYZ(torch.where(c, p.x, q.x),
                     torch.where(c, p.y, q.y),
                     torch.where(c, p.z, q.z))


# --- host <-> device conversion ------------------------------------------------

def points_to_device(points: list[G1], device="cuda") -> PointsXYZ:
    """Host G1 list -> limb-major projective Montgomery tensors [24, N].

    Normalises to affine on the host (one batch inversion, native when
    available) and does the Montgomery form change on the device: a
    multiply by R^2 (the `fq_mul` kernel on the card)."""
    affs = G1.batch_to_affine(points)
    xs = [0 if a is None else a[0] for a in affs]
    ys = [1 if a is None else a[1] for a in affs]
    zs = [0 if a is None else 1 for a in affs]
    device = resolve_device(device)
    r2 = FQ.plain_const(FQ.mont_R2, (1,), device)

    def up(v):
        limbs = torch.from_numpy(ints_to_limbs(v, FQ_LIMBS).T.astype(np.int32))
        return FQ.mul(limbs.to(device), r2)

    return PointsXYZ(up(xs), up(ys), up(zs))


def points_from_device(p: PointsXYZ) -> list[G1]:
    """Limb-major points [24, N] -> host G1 list."""
    def ints(a):
        return [FQ.from_mont(v)
                for v in limbs_to_ints(a.cpu().numpy().T.astype(np.uint32))]

    xs, ys, zs = ints(p.x), ints(p.y), ints(p.z)
    out = []
    zinvs = batch_inversion(zs, Q)
    for x, y, z, zi in zip(xs, ys, zs, zinvs):
        if z == 0:
            out.append(G1.infinity())
        else:
            out.append(G1.from_affine(x * zi % Q, y * zi % Q))
    return out
