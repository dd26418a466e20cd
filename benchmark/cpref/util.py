"""Utility functions used around Curdleproofs.

Parity: `curdleproofs/src/util.rs` (msm wrappers, blinders, verification-scalar
bitstrings, inner products, permutation apply, shuffle helper).
"""

from __future__ import annotations

from .backend import get_backend
from .constants import N_BLINDERS, R
from .host.g1 import G1
from .host.rng import StdRng

__all__ = [
    "msm", "inner_product", "get_permutation", "generate_blinders",
    "get_verification_scalars_bitstring", "verification_scalar_products",
    "scaled_verification_products", "fr_power_vector",
    "shuffle_permute_and_commit_input", "sum_affine_points",
]


def msm(points: list[G1], scalars: list[int]) -> G1:
    """Multi-scalar multiplication through the active backend (util.rs:19-22)."""
    assert len(points) == len(scalars), "number of points != number of scalars"
    return get_backend().msm(points, scalars)


def inner_product(a: list[int], b: list[int]) -> int:
    """Scalar inner product over Fr (util.rs:67-74)."""
    assert len(a) == len(b)
    return sum(x * y for x, y in zip(a, b)) % R


def get_permutation(vec_a: list, permutation: list[int]) -> list:
    """Return `vec_a` permuted: out[j] = vec_a[permutation[j]] (util.rs:77-79)."""
    return [vec_a[i] for i in permutation]


def generate_blinders(rng: StdRng, n: int) -> list[int]:
    """n random Fr elements (util.rs:32-34)."""
    return [rng.rand_fr() for _ in range(n)]


def get_verification_scalars_bitstring(n: int, logn: int) -> list[list[int]]:
    """Binary-decomposition bitstring for O(n) IPA verification (util.rs:40-64).

    bitstring[i] lists the challenge-round indices j whose challenge divides
    into s_i, i.e. rounds where bit (logn-1-j) of i is set.
    """
    bitstring: list[list[int]] = [[] for _ in range(n)]
    for j in range(logn):
        for i in range(n):
            if (i >> (logn - 1 - j)) & 1:
                bitstring[i].append(j)
    return bitstring


def verification_scalar_products(challenges: list[int], n: int) -> list[int]:
    """s_i = prod_{j in bitstring[i]} challenges[j], ONE mul per entry.

    Same output as the bitstring product loop over
    `get_verification_scalars_bitstring` (util.rs:40-64 semantics): round j
    enters s_i iff bit (logn-1-j) of i is set, so with b = lowest set bit of
    i, s_i = s_{i & (i-1)} * challenges[logn-1-b].  Cuts the verifier's
    per-proof scalar work from O(n log n) muls to O(n) — this loop runs once
    per proof in every batch-verification replay.
    """
    logn = len(challenges)
    assert n == 1 << logn
    s = [1] * n
    for i in range(1, n):
        b = (i & -i).bit_length() - 1
        s[i] = s[i & (i - 1)] * challenges[logn - 1 - b] % R
    return s


class FrVec:
    """Concatenated Fr scalar vector whose parts are python-int lists, raw
    canonical 32 B-LE blocks, or nested FrVecs (the verify path's relations
    are built from such parts)."""

    __slots__ = ("parts", "_raw")

    def __init__(self, *parts):
        self.parts = [p for p in parts if not (isinstance(p, list) and not p)]
        self._raw = None

    def __len__(self) -> int:
        return sum(len(p) // 32 if isinstance(p, (bytes, bytearray))
                   else len(p) for p in self.parts)

    def __add__(self, other) -> "FrVec":
        # nest self (don't spread parts): the new FrVec reuses self's _raw
        # cache, so a vector accumulated in several relations serialises once
        return FrVec(self, other)

    def __radd__(self, other) -> "FrVec":
        return FrVec(other, self)

    def to_raw(self) -> bytes:
        """Canonical 32 B-LE concatenation (cached)."""
        if self._raw is None:
            chunks = []
            for p in self.parts:
                if isinstance(p, (bytes, bytearray)):
                    chunks.append(bytes(p))
                elif isinstance(p, FrVec):
                    chunks.append(p.to_raw())
                else:
                    chunks.append(b"".join(
                        (x if 0 <= x < R else x % R).to_bytes(32, "little")
                        for x in p))
            self._raw = b"".join(chunks)
        return self._raw

    def to_ints(self) -> list[int]:
        out: list[int] = []
        for p in self.parts:
            if isinstance(p, (bytes, bytearray)):
                out.extend(int.from_bytes(p[i * 32:(i + 1) * 32], "little")
                           for i in range(len(p) // 32))
            elif isinstance(p, FrVec):
                out.extend(p.to_ints())
            else:
                out.extend(p)
        return out


def scaled_verification_products(challenges: list[int], n: int,
                                 cmul: int | None = None,
                                 mulvec: list[int] | None = None,
                                 neg: bool = False, raw: bool = False):
    """`verification_scalar_products` with the scaling its callers apply
    fused in: out_i = [-] cmul * s_i [* mulvec_i].

    The IPA/SameMsm verifier replays compute `c_final * s_i` (negated, as the
    accumulator's rhs) and `d_final * inv_s_i * u_i`.  `raw` is accepted for
    the callers' sake; the result is always a list of ints."""
    s = verification_scalar_products(challenges, n)
    if cmul is not None:
        s = [cmul * v % R for v in s]
    if mulvec is not None:
        s = [a * b % R for a, b in zip(s, mulvec)]
    if neg:
        s = [-v % R for v in s]
    return s


def fr_power_vector(base: int, n: int) -> list[int]:
    """[base^1, ..., base^n]"""
    out = []
    acc = 1
    for _ in range(n):
        acc = acc * base % R
        out.append(acc)
    return out


def shuffle_permute_and_commit_input(
    crs, vec_R: list[G1], vec_S: list[G1], permutation: list[int], k: int, rng: StdRng,
):
    """Prepare shuffle-proof inputs (util.rs:83-106).

    Returns (vec_T, vec_U, M, vec_m_blinders):
    T = sigma(k*R), U = sigma(k*S), M = Pedersen commitment to sigma.
    """
    ell = len(crs.vec_G)
    backend = get_backend()
    vec_T = get_permutation(backend.batch_mul(vec_R, k), permutation)
    vec_U = get_permutation(backend.batch_mul(vec_S, k), permutation)

    sigma_ell = get_permutation(list(range(ell)), permutation)
    vec_m_blinders = generate_blinders(rng, N_BLINDERS)
    M = msm(crs.vec_G, sigma_ell).add(msm(crs.vec_H, vec_m_blinders))
    return vec_T, vec_U, M, vec_m_blinders


def sum_affine_points(points: list[G1]) -> G1:
    acc = G1.infinity()
    for p in points:
        acc = acc.add(p)
    return acc
