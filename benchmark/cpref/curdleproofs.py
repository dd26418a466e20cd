"""Top-level Curdleproofs shuffle argument (parity: `curdleproofs/src/curdleproofs.rs`).

Proves T = sigma(k*R), U = sigma(k*S) for hidden permutation sigma (committed in M)
and hidden randomizer k, by composing the same-permutation, same-scalar and
same-multiscalar sub-arguments over one Fiat-Shamir transcript and one deferred
MSM accumulator.
"""

from __future__ import annotations

from .backend import get_backend
from .commitments import GroupCommitment
from .constants import N_BLINDERS
from .crs import CurdleproofsCrs
from .errors import VerificationError
from .host.g1 import G1
from .host.rng import StdRng
from .msm_accumulator import MsmAccumulator
from .same_msm import SameMultiscalarProof
from .same_permutation import SamePermutationProof
from .same_scalar import SameScalarProof
from .transcript import Transcript
from .util import generate_blinders, get_permutation, msm
from .utils.trace import span

__all__ = ["CurdleproofsProof", "generate_crs"]


def generate_crs(ell: int) -> CurdleproofsCrs:
    return CurdleproofsCrs.generate_crs(ell)


class CurdleproofsProof:
    __slots__ = ("A", "cm_T", "cm_U", "R", "S",
                 "same_perm_proof", "same_scalar_proof", "same_multiscalar_proof")

    def __init__(self, A, cm_T, cm_U, R, S, same_perm_proof, same_scalar_proof,
                 same_multiscalar_proof):
        self.A = A
        self.cm_T = cm_T
        self.cm_U = cm_U
        self.R = R
        self.S = S
        self.same_perm_proof = same_perm_proof
        self.same_scalar_proof = same_scalar_proof
        self.same_multiscalar_proof = same_multiscalar_proof

    @staticmethod
    def new(
        crs: CurdleproofsCrs,
        vec_R: list[G1],
        vec_S: list[G1],
        vec_T: list[G1],
        vec_U: list[G1],
        M: G1,
        permutation: list[int],
        k: int,
        vec_m_blinders: list[int],
        rng: StdRng,
    ) -> "CurdleproofsProof":
        ell = len(vec_R)
        transcript = Transcript(b"curdleproofs")

        # Step 1
        with span("prover.step1_challenges"):
            for vec in (vec_R, vec_S, vec_T, vec_U):
                transcript.append_point_vec(b"curdleproofs_step1", vec)
            transcript.append_point(b"curdleproofs_step1", M)
            vec_a = transcript.get_and_append_challenges(
                b"curdleproofs_vec_a", ell)

        # Step 2
        vec_a_blinders = generate_blinders(rng, N_BLINDERS - 2)
        vec_r_a_prime = vec_a_blinders + [0, 0]

        vec_a_permuted = get_permutation(vec_a, permutation)
        with span("prover.step2_A_commitment"):
            A = msm(list(crs.vec_G) + list(crs.vec_H),
                    list(vec_a_permuted) + list(vec_r_a_prime))

        with span("prover.same_permutation"):
            same_perm_proof = SamePermutationProof.new(
                crs.vec_G, crs.vec_H, crs.H, A, M, vec_a, permutation,
                vec_r_a_prime, vec_m_blinders, transcript, rng,
                crs_G_sum=crs.G_sum, crs_H_sum=crs.H_sum)

        # Step 3
        r_t = rng.rand_fr()
        r_u = rng.rand_fr()
        with span("prover.same_scalar"):
            R_pt, S_pt = get_backend().msm_many(
                [(vec_R, vec_a), (vec_S, vec_a)])

            cm_T = GroupCommitment.new(crs.G_t, crs.H, R_pt.mul(k), r_t)
            cm_U = GroupCommitment.new(crs.G_u, crs.H, S_pt.mul(k), r_u)

            same_scalar_proof = SameScalarProof.new(
                crs.G_t, crs.G_u, crs.H, R_pt, S_pt, cm_T, cm_U, k, r_t, r_u,
                transcript, rng)

        # Step 4
        A_prime = A.add(cm_T.T_1).add(cm_U.T_1)

        vec_G_with_blinders = (list(crs.vec_G) + list(crs.vec_H[: N_BLINDERS - 2])
                               + [crs.G_t, crs.G_u])
        vec_T_with_blinders = list(vec_T) + [G1.infinity(), G1.infinity(),
                                             crs.H, G1.infinity()]
        vec_U_with_blinders = list(vec_U) + [G1.infinity(), G1.infinity(),
                                             G1.infinity(), crs.H]
        vec_a_with_blinders = vec_a_permuted + vec_a_blinders + [r_t, r_u]

        with span("prover.same_multiscalar"):
            same_multiscalar_proof = SameMultiscalarProof.new(
                vec_G_with_blinders, A_prime, cm_T.T_2, cm_U.T_2,
                vec_T_with_blinders, vec_U_with_blinders, vec_a_with_blinders,
                transcript, rng)

        return CurdleproofsProof(A, cm_T, cm_U, R_pt, S_pt, same_perm_proof,
                                 same_scalar_proof, same_multiscalar_proof)

    def verify(
        self,
        crs: CurdleproofsCrs,
        vec_R: list[G1],
        vec_S: list[G1],
        vec_T: list[G1],
        vec_U: list[G1],
        M: G1,
        rng: StdRng,
    ) -> None:
        """Raises VerificationError on any failed check."""
        msm_accumulator = MsmAccumulator()
        with span("verifier.checks"):
            self.verify_with_accumulator(crs, vec_R, vec_S, vec_T, vec_U, M,
                                         msm_accumulator, rng)
        with span("verifier.final_msm"):
            msm_accumulator.verify()

    def verify_with_accumulator(
        self,
        crs: CurdleproofsCrs,
        vec_R: list[G1],
        vec_S: list[G1],
        vec_T: list[G1],
        vec_U: list[G1],
        M: G1,
        msm_accumulator: MsmAccumulator,
        rng: StdRng,
    ) -> None:
        """All checks except the accumulator's final MSM (caller runs that).

        Sharing one accumulator across many proofs batch-verifies them with a
        single deduped MSM (CRS bases dedup across the whole batch) — see
        the JAX package's parallel/batch_verify.py.
        """
        ell = len(vec_R)
        transcript = Transcript(b"curdleproofs")

        # k = 0 attack: randomizer must not wipe out the ciphertexts
        if vec_T[0].is_infinity():
            raise VerificationError("T[0] is the identity")

        # Step 1
        for vec in (vec_R, vec_S, vec_T, vec_U):
            transcript.append_point_vec(b"curdleproofs_step1", vec)
        transcript.append_point(b"curdleproofs_step1", M)
        vec_a = transcript.get_and_append_challenges(b"curdleproofs_vec_a", ell)

        # Step 2
        self.same_perm_proof.verify(
            crs.vec_G, crs.vec_H, crs.H, crs.G_sum, crs.H_sum, self.A, M,
            vec_a, N_BLINDERS, transcript, msm_accumulator, rng)

        # Step 3 (accumulated; eager in the reference — see same_scalar.py)
        self.same_scalar_proof.verify(
            crs.G_t, crs.G_u, crs.H, self.R, self.S, self.cm_T, self.cm_U,
            transcript, msm_accumulator, rng)

        # Step 4
        A_prime = self.A.add(self.cm_T.T_1).add(self.cm_U.T_1)
        vec_G_with_blinders = (list(crs.vec_G) + list(crs.vec_H[: N_BLINDERS - 2])
                               + [crs.G_t, crs.G_u])
        vec_T_with_blinders = list(vec_T) + [G1.infinity(), G1.infinity(),
                                             crs.H, G1.infinity()]
        vec_U_with_blinders = list(vec_U) + [G1.infinity(), G1.infinity(),
                                             G1.infinity(), crs.H]

        self.same_multiscalar_proof.verify(
            vec_G_with_blinders, A_prime, self.cm_T.T_2, self.cm_U.T_2,
            vec_T_with_blinders, vec_U_with_blinders, transcript,
            msm_accumulator, rng)

        # R/S consistency; the shared FrVec serialises vec_a once for both
        # relations' dedup jobs
        from .util import FrVec

        vec_a_fr = FrVec(vec_a)
        msm_accumulator.accumulate_check(self.R, vec_a_fr, vec_R, rng)
        msm_accumulator.accumulate_check(self.S, vec_a_fr, vec_S, rng)

    # --- serde (curdleproofs.rs:300-323) --------------------------------------
    def serialize(self) -> bytes:
        from .host.serde import g1_to_bytes
        out = bytearray()
        out += g1_to_bytes(self.A)
        out += self.same_scalar_serialize_cm(self.cm_T)
        out += self.same_scalar_serialize_cm(self.cm_U)
        out += g1_to_bytes(self.R)
        out += g1_to_bytes(self.S)
        out += self.same_perm_proof.serialize()
        out += self.same_scalar_proof.serialize()
        out += self.same_multiscalar_proof.serialize()
        return bytes(out)

    @staticmethod
    def same_scalar_serialize_cm(cm: GroupCommitment) -> bytes:
        from .host.serde import g1_to_bytes
        return g1_to_bytes(cm.T_1) + g1_to_bytes(cm.T_2)

    @staticmethod
    def deserialize(buf: bytes | memoryview, log2_n: int) -> "CurdleproofsProof":
        from .host.serde import g1_from_bytes_batch
        buf = memoryview(bytes(buf))

        def take(n):
            nonlocal buf
            chunk, buf = buf[:n], buf[n:]
            return bytes(chunk)

        # one batch decompress for the 7-point header run
        pts = g1_from_bytes_batch([take(48) for _ in range(7)])
        A, cm_T, cm_U, R_pt, S_pt = (pts[0],
                                     GroupCommitment(pts[1], pts[2]),
                                     GroupCommitment(pts[3], pts[4]),
                                     pts[5], pts[6])
        same_perm, buf = SamePermutationProof.deserialize(buf, log2_n)
        same_scalar, buf = SameScalarProof.deserialize(buf)
        same_msm, buf = SameMultiscalarProof.deserialize(buf, log2_n)
        if len(buf) != 0:
            # the reference's whisk boundary enforces exact sizes by array
            # type (curdleproofs/src/whisk.rs:21-25); trailing bytes are
            # a consensus-surface divergence, reject them here
            from .host.serde import SerializationError

            raise SerializationError(
                f"{len(buf)} trailing bytes after proof")
        return CurdleproofsProof(A, cm_T, cm_U, R_pt, S_pt, same_perm,
                                 same_scalar, same_msm)
