"""Grand product argument (parity: `curdleproofs/src/grand_product_argument.rs`).

Proves B = <b, g> + <r_B, h> and p = prod(b_i) by reduction to one inner product
argument over beta-rescaled bases. The verifier uses the CRS sums trick
(`doc/optimizations.md`) to build D with 2 scalar muls instead of n.
"""

from __future__ import annotations

from .backend import get_backend
from .constants import R
from .host.field import fr_inv, fr_pow
from .host.g1 import G1
from .host.rng import StdRng
from .host.serde import fr_from_bytes, fr_to_bytes, g1_from_bytes, g1_to_bytes
from .ipa import InnerProductProof
from .msm_accumulator import MsmAccumulator
from .transcript import Transcript
from .util import fr_power_vector, generate_blinders, inner_product, msm

__all__ = ["GrandProductProof"]


class GrandProductProof:
    __slots__ = ("C", "r_p", "ipa_proof")

    def __init__(self, C: G1, r_p: int, ipa_proof: InnerProductProof):
        self.C = C
        self.r_p = r_p
        self.ipa_proof = ipa_proof

    @staticmethod
    def new(
        crs_G_vec: list[G1],
        crs_H_vec: list[G1],
        crs_U: G1,
        B: G1,
        gprod_result: int,
        vec_b: list[int],
        vec_b_blinders: list[int],
        transcript: Transcript,
        rng: StdRng,
        crs_G_sum=None,
        crs_H_sum=None,
    ) -> "GrandProductProof":
        n_blinders = len(vec_b_blinders)
        ell = len(crs_G_vec)
        backend = get_backend()

        # Step 1
        transcript.append_point(b"gprod_step1", B)
        transcript.append_fr(b"gprod_step1", gprod_result)
        alpha = transcript.get_and_append_challenge(b"gprod_alpha")

        # Step 2: prefix products c = (1, b1, b1*b2, ...)
        vec_c = [1]
        for b_i in vec_b[: ell - 1]:
            vec_c.append(vec_c[-1] * b_i % R)

        vec_c_blinders = generate_blinders(rng, n_blinders)
        C = msm(list(crs_G_vec) + list(crs_H_vec), vec_c + vec_c_blinders)

        vec_r_b_plus_alpha = [(r + alpha) % R for r in vec_b_blinders]
        r_p = inner_product(vec_r_b_plus_alpha, vec_c_blinders)

        transcript.append_point(b"gprod_step2", C)
        transcript.append_fr(b"gprod_step2", r_p)
        beta = transcript.get_and_append_challenge(b"gprod_beta")
        beta_inv = fr_inv(beta)

        # Step 3: rescaled bases and shifted witness
        powers = fr_power_vector(beta_inv, ell + 1)
        beta_inv_pows = powers[:ell]
        vec_G_prime = backend.batch_mul_each(crs_G_vec, beta_inv_pows)

        beta_inv_ell1 = powers[ell]
        vec_H_prime = backend.batch_mul(crs_H_vec, beta_inv_ell1)

        vec_b_prime = []
        pow_beta = beta
        for b_i in vec_b:
            vec_b_prime.append(b_i * pow_beta % R)
            pow_beta = pow_beta * beta % R

        vec_d = []
        vec_beta_powers = []
        pow_beta = 1
        for bp_i in vec_b_prime:
            vec_d.append((bp_i - pow_beta) % R)
            vec_beta_powers.append(pow_beta)
            pow_beta = pow_beta * beta % R

        beta_ell1 = fr_pow(beta, ell + 1)
        vec_d_blinders = [beta_ell1 * f % R for f in vec_r_b_plus_alpha]

        alphabeta = alpha * beta_ell1 % R
        if crs_G_sum is not None and crs_H_sum is not None:
            # The rescalings telescope: <beta-powers, G'> = beta^i *
            # beta^-(i+1) summed = beta^-1 * G_sum, and the H' term is
            # alpha * H_sum — the verifier's CRS-sums trick
            # (doc/optimizations.md:66-93, grand_product_argument.rs:223)
            # works for the prover's D too: 2 muls instead of an ell-MSM.
            D = msm([B, crs_G_sum, crs_H_sum], [1, (-beta_inv) % R, alpha])
        else:
            D = B.add(msm(vec_G_prime, vec_beta_powers).neg()).add(
                msm(vec_H_prime, [alphabeta] * n_blinders))

        # Step 4: one IPA over the concatenated bases
        vec_G = list(crs_G_vec) + list(crs_H_vec)
        vec_G_prime = vec_G_prime + vec_H_prime

        inner_prod = (r_p * beta_ell1 + gprod_result * fr_pow(beta, ell) - 1) % R

        vec_c = vec_c + vec_c_blinders
        vec_d = vec_d + vec_d_blinders

        assert inner_product(vec_c, vec_d) == inner_prod

        ipa_proof = InnerProductProof.new(
            vec_G, vec_G_prime, crs_U, C, D, inner_prod, vec_c, vec_d,
            transcript, rng)

        return GrandProductProof(C, r_p, ipa_proof)

    def verify(
        self,
        crs_G_vec: list[G1],
        crs_H_vec: list[G1],
        crs_U: G1,
        crs_G_sum: G1,
        crs_H_sum: G1,
        B: G1,
        gprod_result: int,
        n_blinders: int,
        transcript: Transcript,
        msm_accumulator: MsmAccumulator,
        rng: StdRng,
    ) -> None:
        ell = len(crs_G_vec)

        # Step 1
        transcript.append_point(b"gprod_step1", B)
        transcript.append_fr(b"gprod_step1", gprod_result)
        alpha = transcript.get_and_append_challenge(b"gprod_alpha")

        # Step 2
        transcript.append_point(b"gprod_step2", self.C)
        transcript.append_fr(b"gprod_step2", self.r_p)
        beta = transcript.get_and_append_challenge(b"gprod_beta")
        beta_inv = fr_inv(beta)

        # Step 3: vec_u for the G'-discrete-log optimization
        # ([beta_inv^1 .. beta_inv^(ell+1)])
        powers = fr_power_vector(beta_inv, ell + 1)
        vec_u = powers[:ell] + [powers[ell]] * n_blinders

        # D from the CRS sums (2 scalar muls instead of n,
        # grand_product_argument.rs:223) — the concrete point is needed for
        # the transcript anyway

        # Step 4
        vec_G = list(crs_G_vec) + list(crs_H_vec)
        inner_prod = (self.r_p * fr_pow(beta, ell + 1)
                      + gprod_result * fr_pow(beta, ell) - 1) % R

        D = msm([B, crs_G_sum, crs_H_sum], [1, (-beta_inv) % R, alpha])

        self.ipa_proof.verify(vec_G, crs_U, self.C, D, inner_prod, vec_u,
                              transcript, msm_accumulator, rng)

    # --- serde (grand_product_argument.rs:345-361) -----------------------------
    def serialize(self) -> bytes:
        return g1_to_bytes(self.C) + fr_to_bytes(self.r_p) + self.ipa_proof.serialize()

    @staticmethod
    def deserialize(buf: memoryview, log2_n: int) -> tuple["GrandProductProof", memoryview]:
        C = g1_from_bytes(bytes(buf[:48]))
        r_p = fr_from_bytes(bytes(buf[48:80]))
        ipa_proof, rest = InnerProductProof.deserialize(buf[80:], log2_n)
        return GrandProductProof(C, r_p, ipa_proof), rest
