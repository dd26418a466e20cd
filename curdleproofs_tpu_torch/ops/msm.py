"""Batched scalar-mul / fold ladders (torch): the JAX package's `ops/msm.py`.

These serve the O(n) one-scalar and per-point scalar-mul primitives of the
all-device backend (`batch_mul`, `batch_mul_each`, `fold_points`), where
every point gets the full 255-bit double-and-add ladder; the MSM itself is
the Pippenger pipeline of `ops/msm_device.py`.

Layout: limb-major [24, N] (see ops/field.py).  Scalars arrive as in the
reference, bit arrays from `ints_to_bits(s % r, NBITS)` (LSB first): [NBITS]
for one scalar, [N, NBITS] for one a point, as a numpy array or a tensor.
Each wrapper packs them on the host into eight 32-bit words a scalar
(`scalar_words`) and runs the ladder on the points' device: on the card
one launch of the `g1_ladder` kernel (ops/kernels.py, csrc/g1_ladder.cu),
whose wrapper splits each scalar on the host (GLV) and uploads its two
signed halves, 40 bytes a scalar; on the CPU its plain version.  The
kernel adds in another order than the reference, so its points are other
projective representatives of the same points (equal after affine
normalization).
The `_plain` functions are the reference's `lax.scan`s as Python loops
over the int64 doubling, complete add and select
(`kernels.g1_ladder_plain`), on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .g1_ops import PointsXYZ
from .kernels import LADDER_BITS, g1_ladder, g1_ladder_plain

__all__ = ["NBITS", "scalar_words", "batch_mul", "batch_mul_each", "fold",
           "batch_mul_plain", "batch_mul_each_plain", "fold_plain"]

NBITS = LADDER_BITS


def scalar_words(bits, device, per_point: bool = False) -> torch.Tensor:
    """[NBITS] bits -> [8] int32 words on `device`, or with `per_point`
    [N, NBITS] -> [8, N] (little-endian words, the bit patterns of uint32;
    word-major, so the card's lanes read neighbouring words)."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    b = np.asarray(bits, dtype=np.uint8)
    if b.ndim != 1 + per_point or b.shape[-1] != NBITS:
        want = f"[N, {NBITS}]" if per_point else f"[{NBITS}]"
        raise ValueError(f"scalar bits are {want}, got {list(b.shape)}")
    pad = np.zeros((*b.shape[:-1], 256 - NBITS), dtype=np.uint8)
    packed = np.packbits(np.concatenate([b, pad], axis=-1), axis=-1,
                         bitorder="little")
    words = np.ascontiguousarray(packed).view("<u4").view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(words.T)).to(device)


def batch_mul_plain(points: PointsXYZ, bits) -> PointsXYZ:
    """[k * P for P in points] for ONE scalar given as [NBITS] bits."""
    return g1_ladder_plain(points, scalar_words(bits, points.x.device))


def batch_mul_each_plain(points: PointsXYZ, bits) -> PointsXYZ:
    """[k_i * P_i] with per-point scalars; bits: [N, NBITS]."""
    return g1_ladder_plain(points, scalar_words(bits, points.x.device, True))


def fold_plain(left: PointsXYZ, right: PointsXYZ, bits) -> PointsXYZ:
    """left[i] + gamma * right[i]; gamma given as [NBITS] bits."""
    return g1_ladder_plain(right, scalar_words(bits, right.x.device), left)


def batch_mul(points: PointsXYZ, bits) -> PointsXYZ:
    """`batch_mul_plain`'s points; one `g1_ladder` launch for points on the
    card (the words stay on the host, where the kernel's wrapper splits
    them)."""
    return g1_ladder(points, scalar_words(bits, "cpu"))


def batch_mul_each(points: PointsXYZ, bits) -> PointsXYZ:
    """`batch_mul_each_plain`'s points; one `g1_ladder` launch on the
    card."""
    return g1_ladder(points, scalar_words(bits, "cpu", True))


def fold(left: PointsXYZ, right: PointsXYZ, bits) -> PointsXYZ:
    """`fold_plain`'s points; one `g1_ladder` launch on the card."""
    return g1_ladder(right, scalar_words(bits, "cpu"), left)
