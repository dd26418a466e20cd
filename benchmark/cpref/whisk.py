"""Whisk application layer — Ethereum SSLE glue (parity: `curdleproofs/src/whisk.rs`).

Byte-oriented API over trackers `(r*G, k*r*G)` and fixed-size shuffle proofs
(the benchmark's sync cell; the tracker opening proofs are not part of it).
"""

from __future__ import annotations

from .constants import WHISK_SHUFFLE_PROOF_SIZE
from .crs import CurdleproofsCrs
from .curdleproofs import CurdleproofsProof
from .errors import VerificationError
from .host.g1 import G1, GENERATOR
from .host.rng import StdRng
from .host.serde import (
    SerializationError, deferred_subgroup_checks, g1_from_bytes,
    g1_from_bytes_batch, g1_to_bytes,
)
from .util import shuffle_permute_and_commit_input

__all__ = [
    "WhiskTracker", "WhiskShuffleProof", "generate_whisk_shuffle_proof",
    "is_valid_whisk_shuffle_proof", "whisk_shuffle_proof_size",
]


class WhiskTracker:
    """48-byte compressed pair (r*G, k*r*G)."""

    __slots__ = ("r_G", "k_r_G")

    def __init__(self, r_G: bytes, k_r_G: bytes):
        self.r_G = r_G
        self.k_r_G = k_r_G

    @staticmethod
    def from_k_r(k: int, r: int) -> "WhiskTracker":
        r_G = GENERATOR.mul(r)
        k_r_G = r_G.mul(k)
        return WhiskTracker(g1_to_bytes(r_G), g1_to_bytes(k_r_G))

    @staticmethod
    def from_k(rng: StdRng, k: int) -> "WhiskTracker":
        return WhiskTracker.from_k_r(k, rng.rand_fr())

    @staticmethod
    def from_rand(rng: StdRng) -> "WhiskTracker":
        k = rng.rand_fr()
        return WhiskTracker.from_k(rng, k)

    def __eq__(self, other):
        if not isinstance(other, WhiskTracker):
            return NotImplemented
        return self.r_G == other.r_G and self.k_r_G == other.k_r_G


def whisk_shuffle_proof_size(log2_n: int) -> int:
    """Exact byte size of a serialized whisk shuffle proof at a given IPA
    depth: 48 (M) + 1088 fixed + 480 per folding round (the 4·log2_n IPA
    points + 6·log2_n sameMsm points, 48 B each).  Cross-checks the
    reference's published sizes (curdleproofs/README.md:47-49: 3968/
    4448/4928 at log2_n = 6/7/8) and WHISK_SHUFFLE_PROOF_SIZE = 4496 at
    the whisk config (log2_n = 7)."""
    return 48 + 1088 + 480 * log2_n


assert whisk_shuffle_proof_size(7) == WHISK_SHUFFLE_PROOF_SIZE


class WhiskShuffleProof:
    __slots__ = ("M", "proof")

    def __init__(self, M: G1, proof: CurdleproofsProof):
        self.M = M
        self.proof = proof

    def serialize(self) -> bytes:
        out = g1_to_bytes(self.M) + self.proof.serialize()
        assert len(out) == whisk_shuffle_proof_size(
            len(self.proof.same_multiscalar_proof.vec_L_A))
        return out

    @staticmethod
    def deserialize(buf: bytes, log2_n: int) -> "WhiskShuffleProof":
        # exact fixed size per log2_n — at the whisk config (ELL=124,
        # log2_n=7) this is WHISK_SHUFFLE_PROOF_SIZE = 4496, matching the
        # reference's `WhiskShuffleProofBytes = [u8; 4496]`
        # (curdleproofs/src/whisk.rs:23,31); trailing bytes rejected.
        want = whisk_shuffle_proof_size(log2_n)
        if len(buf) != want:
            raise SerializationError(
                f"whisk shuffle proof must be exactly {want} bytes for "
                f"log2_n={log2_n}, got {len(buf)}")
        M = g1_from_bytes(buf[:48])
        proof = CurdleproofsProof.deserialize(buf[48:], log2_n)
        return WhiskShuffleProof(M, proof)


def _unzip_trackers(trackers) -> tuple[list[G1], list[G1]]:
    both = g1_from_bytes_batch([t.r_G for t in trackers]
                               + [t.k_r_G for t in trackers])
    return both[: len(trackers)], both[len(trackers) :]


def _zip_trackers(vec_r: list[G1], vec_s: list[G1]) -> list[WhiskTracker]:
    return [WhiskTracker(g1_to_bytes(r), g1_to_bytes(s))
            for r, s in zip(vec_r, vec_s)]


def generate_whisk_shuffle_proof(
    rng: StdRng, crs: CurdleproofsCrs, pre_trackers: list[WhiskTracker],
) -> tuple[list[WhiskTracker], bytes]:
    """Create and serialize a whisk shuffle proof (whisk.rs:144-179)."""
    ell = len(crs.vec_G)
    permutation = list(range(ell))
    rng.shuffle(permutation)
    k = rng.rand_fr()

    vec_r, vec_s = _unzip_trackers(pre_trackers)
    vec_t, vec_u, m, vec_m_blinders = shuffle_permute_and_commit_input(
        crs, vec_r, vec_s, permutation, k, rng)

    proof = CurdleproofsProof.new(crs, vec_r, vec_s, vec_t, vec_u, m,
                                  permutation, k, vec_m_blinders, rng)

    out = WhiskShuffleProof(m, proof).serialize()
    assert len(out) == 48 + len(proof.serialize())
    return _zip_trackers(vec_t, vec_u), out


def is_valid_whisk_shuffle_proof(
    rng: StdRng, crs: CurdleproofsCrs,
    pre_trackers: list[WhiskTracker], post_trackers: list[WhiskTracker],
    whisk_shuffle_proof_bytes: bytes,
) -> bool:
    vec_r, vec_s = _unzip_trackers(pre_trackers)
    vec_t, vec_u = _unzip_trackers(post_trackers)
    with deferred_subgroup_checks():
        wsp = WhiskShuffleProof.deserialize(whisk_shuffle_proof_bytes,
                                            crs.log2_n())
    try:
        wsp.proof.verify(crs, vec_r, vec_s, vec_t, vec_u, wsp.M, rng)
        return True
    except VerificationError:
        return False
