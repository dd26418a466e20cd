"""Same permutation argument (parity: `curdleproofs/src/same_permutation_argument.rs`).

Neff's trick: A and M commit under the same sigma iff both sides of
prod(a_i + i*alpha + beta) agree; reduces to one grand product over
B = A + alpha*M + beta*<1, g>.
"""

from __future__ import annotations

from .constants import R
from .grand_product import GrandProductProof
from .host.g1 import G1
from .host.rng import StdRng
from .host.serde import g1_from_bytes, g1_to_bytes
from .msm_accumulator import MsmAccumulator
from .transcript import Transcript
from .util import get_permutation, msm

__all__ = ["SamePermutationProof"]


class SamePermutationProof:
    __slots__ = ("B", "grand_product_proof")

    def __init__(self, B: G1, grand_product_proof: GrandProductProof):
        self.B = B
        self.grand_product_proof = grand_product_proof

    @staticmethod
    def new(
        crs_G_vec: list[G1],
        crs_H_vec: list[G1],
        crs_U: G1,
        A: G1,
        M: G1,
        vec_a: list[int],
        permutation: list[int],
        vec_a_blinders: list[int],
        vec_m_blinders: list[int],
        transcript: Transcript,
        rng: StdRng,
        crs_G_sum=None,
        crs_H_sum=None,
    ) -> "SamePermutationProof":
        n_blinders = len(vec_a_blinders)
        ell = len(crs_G_vec)

        # Step 1
        transcript.append_points(b"same_perm_step1", [A, M])
        transcript.append_fr_vec(b"same_perm_step1", vec_a)
        alpha = transcript.get_and_append_challenge(b"same_perm_alpha")
        beta = transcript.get_and_append_challenge(b"same_perm_beta")

        # Step 2
        vec_a_permuted = get_permutation(vec_a, permutation)
        factors = [(a + m * alpha + beta) % R
                   for a, m in zip(vec_a_permuted, permutation)]
        gprod_result = 1
        for f in factors:
            gprod_result = gprod_result * f % R

        if crs_G_sum is not None:
            # <beta*1, G> = beta * G_sum: the CRS sum replaces the ell-MSM
            # of same_permutation_argument.rs:76 (2-point MSM + A).
            B = A.add(msm([M, crs_G_sum], [alpha, beta]))
        else:
            B = A.add(M.mul(alpha)).add(msm(crs_G_vec, [beta] * ell))

        vec_b_blinders = [(vec_a_blinders[i] + alpha * vec_m_blinders[i]) % R
                          for i in range(n_blinders)]

        grand_product_proof = GrandProductProof.new(
            crs_G_vec, crs_H_vec, crs_U, B, gprod_result, factors,
            vec_b_blinders, transcript, rng,
            crs_G_sum=crs_G_sum, crs_H_sum=crs_H_sum)

        return SamePermutationProof(B, grand_product_proof)

    def verify(
        self,
        crs_G_vec: list[G1],
        crs_H_vec: list[G1],
        crs_U: G1,
        crs_G_sum: G1,
        crs_H_sum: G1,
        A: G1,
        M: G1,
        vec_a: list[int],
        n_blinders: int,
        transcript: Transcript,
        msm_accumulator: MsmAccumulator,
        rng: StdRng,
    ) -> None:
        ell = len(crs_G_vec)

        # Step 1
        transcript.append_points(b"same_perm_step1", [A, M])
        transcript.append_fr_vec(b"same_perm_step1", vec_a)
        alpha = transcript.get_and_append_challenge(b"same_perm_alpha")
        beta = transcript.get_and_append_challenge(b"same_perm_beta")

        # Step 2
        gprod_result = 1
        for i, a in enumerate(vec_a):
            gprod_result = gprod_result * ((a + i * alpha + beta) % R) % R

        # accumulate: (B - A - alpha*M) == <beta*1, g>, in zero form so the
        # alpha-mul rides the single deduped MSM too
        msm_accumulator.accumulate_zero(
            [1, -1 % R, -alpha % R] + [-beta % R] * ell,
            [self.B, A, M] + list(crs_G_vec), rng)

        self.grand_product_proof.verify(
            crs_G_vec, crs_H_vec, crs_U, crs_G_sum, crs_H_sum, self.B,
            gprod_result, n_blinders, transcript, msm_accumulator, rng)

    # --- serde -----------------------------------------------------------
    def serialize(self) -> bytes:
        return g1_to_bytes(self.B) + self.grand_product_proof.serialize()

    @staticmethod
    def deserialize(buf: memoryview, log2_n: int) -> tuple["SamePermutationProof", memoryview]:
        B = g1_from_bytes(bytes(buf[:48]))
        gp, rest = GrandProductProof.deserialize(buf[48:], log2_n)
        return SamePermutationProof(B, gp), rest
