"""Whisk application layer — Ethereum SSLE glue (parity: `curdleproofs/src/whisk.rs`).

Byte-oriented API over trackers `(r*G, k*r*G)`, fixed-size shuffle proofs, and
Schnorr-style DLEQ tracker opening proofs.
"""

from __future__ import annotations

import bisect

from .constants import (
    FIELD_ELEMENT_SIZE, G1POINT_SIZE, R, TRACKER_PROOF_SIZE, WHISK_ELL,
    WHISK_SHUFFLE_PROOF_SIZE,
)
from .crs import CurdleproofsCrs
from .curdleproofs import CurdleproofsProof
from .errors import VerificationError
from .host.g1 import G1, GENERATOR
from .host.rng import StdRng
from .msm_accumulator import MsmAccumulator
from .host.serde import (
    SerializationError, fr_from_bytes, fr_from_le_bytes_mod_order,
    fr_to_bytes, g1_from_bytes, g1_from_bytes_batch, deferred_subgroup_checks,
    g1_to_bytes,
)
from .transcript import Transcript
from .util import shuffle_permute_and_commit_input
from .utils.trace import span

__all__ = [
    "WhiskTracker", "WhiskShuffleProof", "TrackerProof",
    "generate_whisk_shuffle_proof", "is_valid_whisk_shuffle_proof",
    "is_valid_whisk_shuffle_proofs",
    "generate_whisk_tracker_proof", "is_valid_whisk_tracker_proof",
    "to_bytes_g1affine", "from_bytes_g1affine", "to_bytes_fr", "from_bytes_fr",
    "g1_generator", "bls_g1_scalar_multiply", "rand_scalar",
    "FIELD_ELEMENT_SIZE", "G1POINT_SIZE", "WHISK_SHUFFLE_PROOF_SIZE",
    "TRACKER_PROOF_SIZE", "WHISK_ELL", "whisk_shuffle_proof_size",
]


# --- byte codecs (whisk.rs:307-345) ------------------------------------------
def to_bytes_g1affine(p: G1) -> bytes:
    return g1_to_bytes(p)


def from_bytes_g1affine(buf: bytes) -> G1:
    return g1_from_bytes(buf)


def to_bytes_fr(v: int) -> bytes:
    return fr_to_bytes(v)


def from_bytes_fr(buf: bytes) -> int:
    return fr_from_le_bytes_mod_order(buf)


def g1_generator() -> G1:
    return GENERATOR


def bls_g1_scalar_multiply(p: G1, scalar: int) -> G1:
    return p.mul(scalar)


def rand_scalar(rng: StdRng) -> int:
    return rng.rand_fr()


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


class TrackerProof:
    __slots__ = ("A", "B", "s")

    def __init__(self, A: G1, B: G1, s: int):
        self.A = A
        self.B = B
        self.s = s

    def serialize(self) -> bytes:
        out = g1_to_bytes(self.A) + g1_to_bytes(self.B) + fr_to_bytes(self.s)
        assert len(out) == TRACKER_PROOF_SIZE
        return out

    @staticmethod
    def deserialize(buf: bytes) -> "TrackerProof":
        # fixed 128-byte boundary, exact — matches the reference's
        # `TrackerProofBytes = [u8; 128]` (curdleproofs/src/whisk.rs:25,34)
        if len(buf) != TRACKER_PROOF_SIZE:
            from .host.serde import SerializationError

            raise SerializationError(
                f"tracker proof must be exactly {TRACKER_PROOF_SIZE} bytes, "
                f"got {len(buf)}")
        return TrackerProof(g1_from_bytes(buf[:48]), g1_from_bytes(buf[48:96]),
                            fr_from_bytes(buf[96:128]))


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
            from .host.serde import SerializationError

            raise SerializationError(
                f"whisk shuffle proof must be exactly {want} bytes for "
                f"log2_n={log2_n}, got {len(buf)}")
        M = g1_from_bytes(buf[:48])
        proof = CurdleproofsProof.deserialize(buf[48:], log2_n)
        return WhiskShuffleProof(M, proof)


def _unzip_trackers(*tracker_lists, where=None) -> list[list[G1]]:
    """Decompress tracker lists in one call: each list's r_G points, then
    its k_r_G points, list after list.  Returns each list's r_G and k_r_G
    vectors in that order: `vec_r, vec_s = _unzip_trackers(trackers)`.

    A bad point raises the `SerializationError` that one call a list, in
    this order, would raise first, after `where(k)`, the name of its list
    k, where the caller passes one."""
    bufs, starts = [], []
    for trackers in tracker_lists:
        starts.append(len(bufs))
        bufs += [t.r_G for t in trackers]
        bufs += [t.k_r_G for t in trackers]
    with span("whisk.unzip_trackers", timeline=False, points=len(bufs)):
        try:
            pts = g1_from_bytes_batch(bufs)
        except SerializationError as e:
            if where is None:
                raise
            # the lowest failing point's list is the first list that fails;
            # alone, it raises what its own call raised
            k = bisect.bisect_right(starts, e.index) - 1
            n = len(tracker_lists[k])
            try:
                g1_from_bytes_batch(bufs[starts[k]:starts[k] + 2 * n])
            except SerializationError as first:
                raise SerializationError(f"{where(k)}: {first}") from None
            raise
    out = []
    for trackers, at in zip(tracker_lists, starts):
        n = len(trackers)
        out += [pts[at:at + n], pts[at + n:at + 2 * n]]
    return out


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


def is_valid_whisk_shuffle_proofs(
    rng: StdRng, crs: CurdleproofsCrs,
    shuffles: "list[tuple[list[WhiskTracker], list[WhiskTracker], bytes]]",
    identify: bool = False,
) -> "bool | list[bool]":
    """Byte-level batch twin of `is_valid_whisk_shuffle_proof` (new
    capability; the reference verifies one shuffle per call, whisk.rs:106).

    `shuffles` is a list of (pre_trackers, post_trackers, proof_bytes),
    e.g. a chain-sync segment of Whisk shuffle blocks.  All proofs share one
    deduped accumulator MSM (`parallel/batch_verify.py`), which the active
    backend runs, and consecutive blocks' tracker lists overlap (block k's
    post == block k+1's pre), so the validated-decompress cache collapses
    their sqrt + subgroup work.

    All-or-nothing bool; `identify=True` bisects to per-shuffle verdicts on
    failure.  Malformed bytes raise SerializationError (same surface as the
    single-proof path).
    """
    from .parallel.batch_verify import ShuffleInstance, batch_verify

    # The tracker unzip stays OUTSIDE the deferred context: the eager path
    # fuses the subgroup ladder into the decompress call on already-loaded
    # affine coordinates, which beats deferring (defer = re-serialize +
    # re-load the points for a separate ladder).  It is one native call for
    # every block's pre- and post-trackers, split across the process's
    # cores.  Deferral only wins for the proofs' scattered small point
    # groups, where ONE context spans the segment.
    with span("whisk.verify_batch", blocks=len(shuffles)):
        vecs = _unzip_trackers(
            *(lst for pre, post, _ in shuffles for lst in (pre, post)),
            where=lambda k: f"block {k // 2} {('pre', 'post')[k % 2]}"
                            "_trackers")
        instances = [ShuffleInstance(*vecs[4 * b:4 * b + 4], None)
                     for b in range(len(shuffles))]
        proofs = []
        with span("whisk.proof_bytes"), deferred_subgroup_checks():
            # ONE ladder for ~90 x B proof points
            for inst, (_, _, proof_bytes) in zip(instances, shuffles):
                wsp = WhiskShuffleProof.deserialize(proof_bytes, crs.log2_n())
                inst.M = wsp.M
                proofs.append(wsp.proof)
        return batch_verify(crs, instances, proofs, rng, identify=identify)


def generate_whisk_tracker_proof(rng: StdRng, tracker: WhiskTracker,
                                 k: int) -> bytes:
    """Schnorr DLEQ opening proof (whisk.rs:228-263)."""
    k_r_g = g1_from_bytes(tracker.k_r_G)
    r_g = g1_from_bytes(tracker.r_G)
    G = GENERATOR

    k_G = G.mul(k)
    blinder = rng.rand_fr()
    A = G.mul(blinder)
    B = r_g.mul(blinder)

    transcript = Transcript(b"whisk_opening_proof")
    transcript.append_points(b"tracker_opening_proof",
                             [k_G, G, k_r_g, r_g, A, B])
    challenge = transcript.get_and_append_challenge(
        b"tracker_opening_proof_challenge")
    s = (blinder - challenge * k) % R

    return TrackerProof(A, B, s).serialize()


def is_valid_whisk_tracker_proof(tracker: WhiskTracker, k_commitment: bytes,
                                 tracker_proof: bytes) -> bool:
    proof = TrackerProof.deserialize(tracker_proof)
    k_r_G = g1_from_bytes(tracker.k_r_G)
    r_G = g1_from_bytes(tracker.r_G)
    k_G = g1_from_bytes(k_commitment)
    G = GENERATOR

    transcript = Transcript(b"whisk_opening_proof")
    transcript.append_points(b"tracker_opening_proof",
                             [k_G, G, k_r_G, r_G, proof.A, proof.B])
    challenge = transcript.get_and_append_challenge(
        b"tracker_opening_proof_challenge")

    A_prime = G.mul(proof.s).add(k_G.mul(challenge))
    B_prime = r_G.mul(proof.s).add(k_r_G.mul(challenge))
    return A_prime == proof.A and B_prime == proof.B


def is_valid_whisk_tracker_proofs(
    trackers: list[WhiskTracker], k_commitments: list[bytes],
    tracker_proofs: list[bytes], rng: StdRng,
    identify: bool = False,
) -> "bool | list[bool]":
    """Batch-verify many tracker opening proofs with ONE accumulated MSM.

    New capability (the reference verifies one proof per call,
    whisk.rs:183-225): both Schnorr checks of every proof enter a random
    linear combination — `A == s*G + c*kG` and `B == s*rG + c*krG` — so B
    proofs cost B transcript replays plus a single ~(5B+1)-base MSM instead
    of 4B scalar muls; all points are batch-decompressed (validated, so the
    RLC runs in the prime-order subgroup).  This is the chain-sync access
    pattern: validating a block's worth of opening proofs at once.

    All-or-nothing; `identify=True` bisects to per-proof verdicts on
    failure.  Malformed bytes raise SerializationError, as the single-proof
    deserialization path does.
    """
    assert len(trackers) == len(k_commitments) == len(tracker_proofs)
    n = len(trackers)
    pts = g1_from_bytes_batch(
        [t.k_r_G for t in trackers] + [t.r_G for t in trackers]
        + list(k_commitments)
        + [p[:48] for p in tracker_proofs] + [p[48:96] for p in tracker_proofs])
    svals = [fr_from_bytes(p[96:128]) for p in tracker_proofs]
    k_r_Gs, r_Gs = pts[:n], pts[n:2 * n]
    k_Gs, As, Bs = pts[2 * n:3 * n], pts[3 * n:4 * n], pts[4 * n:5 * n]
    G = GENERATOR

    def run(idx: "list[int]") -> bool:
        acc = MsmAccumulator()
        for i in idx:
            transcript = Transcript(b"whisk_opening_proof")
            transcript.append_points(
                b"tracker_opening_proof",
                [k_Gs[i], G, k_r_Gs[i], r_Gs[i], As[i], Bs[i]])
            c = transcript.get_and_append_challenge(
                b"tracker_opening_proof_challenge")
            acc.accumulate_check(As[i], [svals[i], c], [G, k_Gs[i]], rng)
            acc.accumulate_check(Bs[i], [svals[i], c], [r_Gs[i], k_r_Gs[i]],
                                 rng)
        try:
            acc.verify()
            return True
        except VerificationError:
            return False

    ok = run(list(range(n)))
    if ok or not identify:
        return ok
    verdicts = [True] * n

    def bisect(idx: "list[int]") -> None:
        if len(idx) == 1:
            verdicts[idx[0]] = run(idx)
            return
        mid = len(idx) // 2
        for part in (idx[:mid], idx[mid:]):
            if not run(part):
                bisect(part)

    bisect(list(range(n)))
    return verdicts
