"""Host-side BLS12-381 field arithmetic over canonical Python integers.

This is the latency-optimal scalar path (single elements, transcript challenges,
fold coefficients) and the golden model the TPU kernels are tested against.
Vectors of field ops go through `curdleproofs_tpu_torch.ops` on device instead.

Values are canonical integers in [0, modulus). arkworks' internal Montgomery
representation is never materialised; where it leaks into observable behaviour
(sampling, see `host/rng.py`) we convert explicitly.
"""

from __future__ import annotations

from ..constants import Q, R

__all__ = [
    "fr_add", "fr_sub", "fr_mul", "fr_neg", "fr_inv", "fr_pow",
    "fq_add", "fq_sub", "fq_mul", "fq_neg", "fq_inv", "fq_sqrt",
    "batch_inversion", "Q", "R",
]


def fr_add(a: int, b: int) -> int:
    c = a + b
    return c - R if c >= R else c


def fr_sub(a: int, b: int) -> int:
    c = a - b
    return c + R if c < 0 else c


def fr_mul(a: int, b: int) -> int:
    return a * b % R


def fr_neg(a: int) -> int:
    return R - a if a else 0


def fr_inv(a: int) -> int:
    return pow(a, -1, R)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, R)


def fq_add(a: int, b: int) -> int:
    c = a + b
    return c - Q if c >= Q else c


def fq_sub(a: int, b: int) -> int:
    c = a - b
    return c + Q if c < 0 else c


def fq_mul(a: int, b: int) -> int:
    return a * b % Q


def fq_neg(a: int) -> int:
    return Q - a if a else 0


def fq_inv(a: int) -> int:
    return pow(a, -1, Q)


_SQRT_EXP = (Q + 1) // 4  # q == 3 (mod 4)


def fq_sqrt(a: int) -> int | None:
    """Return a square root of `a` in Fq, or None if `a` is a non-residue."""
    if a == 0:
        return 0
    y = pow(a, _SQRT_EXP, Q)
    if y * y % Q != a:
        return None
    return y


def batch_inversion(values: list[int], modulus: int = R) -> list[int]:
    """Montgomery's trick: invert a list with one modular inversion.

    Zero entries are passed through unchanged, matching arkworks'
    `batch_inversion` behaviour (it skips zeros).
    """
    n = len(values)
    prefix = [0] * n
    acc = 1
    for i, v in enumerate(values):
        prefix[i] = acc
        if v:
            acc = acc * v % modulus
    inv = pow(acc, -1, modulus)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v:
            out[i] = inv * prefix[i] % modulus
            inv = inv * v % modulus
        else:
            out[i] = 0
    return out
