"""Inner product argument (parity: `curdleproofs/src/inner_product_argument.rs`).

Proves knowledge of c, d with C = <c, G>, D = <d, G'>, z = <c, d>, in log n
folding rounds. The verifier is O(n): it recomputes verification scalars
s_i = prod gamma_j^{b_ij} and defers two MSM checks to the accumulator.
"""

from __future__ import annotations

from .backend import get_backend
from .constants import R
from .errors import VerificationError
from .host.field import batch_inversion, fr_inv
from .host.g1 import G1
from .host.rng import StdRng
from .host.serde import (
    fr_from_bytes, fr_to_bytes, g1_from_bytes_batch, g1_to_bytes,
)
from .msm_accumulator import MsmAccumulator
from .transcript import Transcript
from .util import (
    FrVec, generate_blinders, inner_product,
    scaled_verification_products, verification_scalar_products,
)

__all__ = ["InnerProductProof", "generate_ipa_blinders"]


def generate_ipa_blinders(rng: StdRng, c: list[int], d: list[int]) -> tuple[list[int], list[int]]:
    """Blinders r, z with <r,d> + <z,c> == 0 and <r,z> == 0 (reference :42-82).

    Draws n + (n-2) random elements, then solves a 2x2 linear system for the
    last two z coordinates.
    """
    n = len(c)
    r = generate_blinders(rng, n)
    z = generate_blinders(rng, n - 2)

    omega = (inner_product(r, d) + inner_product(z[: n - 2], c[: n - 2])) % R
    delta = inner_product(r[: n - 2], z[: n - 2])

    inv_c = fr_inv(c[n - 2])
    denom = (-r[n - 2] * inv_c % R * c[n - 1] + r[n - 1]) % R
    last_z = (r[n - 2] * inv_c % R * omega - delta) % R * fr_inv(denom) % R
    penultimate_z = -inv_c * ((last_z * c[n - 1] + omega) % R) % R

    z.append(penultimate_z)
    z.append(last_z)

    assert (inner_product(r, d) + inner_product(z, c)) % R == 0
    assert inner_product(r, z) == 0
    return r, z


class InnerProductProof:
    __slots__ = ("B_c", "B_d", "vec_L_C", "vec_R_C", "vec_L_D", "vec_R_D",
                 "c_final", "d_final")

    def __init__(self, B_c, B_d, vec_L_C, vec_R_C, vec_L_D, vec_R_D, c_final, d_final):
        self.B_c = B_c
        self.B_d = B_d
        self.vec_L_C = vec_L_C
        self.vec_R_C = vec_R_C
        self.vec_L_D = vec_L_D
        self.vec_R_D = vec_R_D
        self.c_final = c_final
        self.d_final = d_final

    # --- prover ------------------------------------------------------------
    @staticmethod
    def new(
        crs_G_vec: list[G1],
        crs_G_prime_vec: list[G1],
        crs_H: G1,
        C: G1,
        D: G1,
        z: int,
        vec_c: list[int],
        vec_d: list[int],
        transcript: Transcript,
        rng: StdRng,
    ) -> "InnerProductProof":
        n = len(vec_c)
        assert len(vec_d) == n and n & (n - 1) == 0, "n must be a power of two"
        backend = get_backend()

        vec_G = list(crs_G_vec)
        vec_G_prime = list(crs_G_prime_vec)
        vec_c = list(vec_c)
        vec_d = list(vec_d)

        # Step 1: blind the witness
        vec_r_c, vec_r_d = generate_ipa_blinders(rng, vec_c, vec_d)
        B_c, B_d = backend.msm_many([(vec_G, vec_r_c),
                                     (vec_G_prime, vec_r_d)])

        transcript.append_points(b"ipa_step1", [C, D])
        transcript.append_fr(b"ipa_step1", z)
        transcript.append_points(b"ipa_step1", [B_c, B_d])
        alpha = transcript.get_and_append_challenge(b"ipa_alpha")
        beta = transcript.get_and_append_challenge(b"ipa_beta")

        vec_c = [(rc + alpha * c) % R for rc, c in zip(vec_r_c, vec_c)]
        vec_d = [(rd + alpha * d) % R for rd, d in zip(vec_r_d, vec_d)]
        H = crs_H.mul(beta)

        # Step 2: log n folding rounds
        vec_L_C, vec_R_C, vec_L_D, vec_R_D = [], [], [], []
        while len(vec_c) > 1:
            half = len(vec_c) // 2
            c_L, c_R = vec_c[:half], vec_c[half:]
            d_L, d_R = vec_d[:half], vec_d[half:]
            G_L, G_R = vec_G[:half], vec_G[half:]
            Gp_L, Gp_R = vec_G_prime[:half], vec_G_prime[half:]

            m_LC, L_D, m_RC, R_D = backend.msm_many(
                [(G_R, c_L), (Gp_L, d_R), (G_L, c_R), (Gp_R, d_L)])
            L_C = m_LC.add(H.mul(inner_product(c_L, d_R)))
            R_C = m_RC.add(H.mul(inner_product(c_R, d_L)))

            vec_L_C.append(L_C)
            vec_L_D.append(L_D)
            vec_R_C.append(R_C)
            vec_R_D.append(R_D)

            transcript.append_points(b"ipa_loop", [L_C, L_D, R_C, R_D])
            gamma = transcript.get_and_append_challenge(b"ipa_gamma")
            gamma_inv = fr_inv(gamma)

            vec_c = [(l + gamma_inv * r) % R for l, r in zip(c_L, c_R)]
            vec_d = [(l + gamma * r) % R for l, r in zip(d_L, d_R)]
            # the gamma and gamma_inv folds run as ONE per-point-scalar call
            folded = backend.fold_points_each(
                G_L + Gp_L, G_R + Gp_R, [gamma] * half + [gamma_inv] * half)
            vec_G = folded[:half]
            vec_G_prime = folded[half:]

        return InnerProductProof(B_c, B_d, vec_L_C, vec_R_C, vec_L_D, vec_R_D,
                                 vec_c[0], vec_d[0])

    # --- verifier ------------------------------------------------------------
    def verification_scalars(self, n: int, transcript: Transcript):
        lg_n = len(self.vec_L_C)
        if lg_n >= 32 or n != (1 << lg_n):
            raise VerificationError("bad IPA proof shape")

        challenges: list[int] = []
        for i in range(lg_n):
            transcript.append_points(
                b"ipa_loop",
                [self.vec_L_C[i], self.vec_L_D[i], self.vec_R_C[i], self.vec_R_D[i]])
            challenges.append(transcript.get_and_append_challenge(b"ipa_gamma"))

        challenges_inv = batch_inversion(challenges, R)

        # one mul per entry (inner_product_argument.rs:250-272 computes the
        # same products from the bitstring; see verification_scalar_products)
        vec_s = verification_scalar_products(challenges, n)
        vec_inv_s = verification_scalar_products(challenges_inv, n)
        return challenges, challenges_inv, vec_s, vec_inv_s

    def verify(
        self,
        crs_G_vec: list[G1],
        crs_H: G1,
        C: G1,
        D: G1,
        z: int,
        vec_u: list[int],
        transcript: Transcript,
        msm_accumulator: MsmAccumulator,
        rng: StdRng,
    ) -> None:
        n = len(crs_G_vec)
        assert n & (n - 1) == 0

        # Step 1
        transcript.append_points(b"ipa_step1", [C, D])
        transcript.append_fr(b"ipa_step1", z)
        transcript.append_points(b"ipa_step1", [self.B_c, self.B_d])
        alpha = transcript.get_and_append_challenge(b"ipa_alpha")
        beta = transcript.get_and_append_challenge(b"ipa_beta")

        # Step 2 (the challenge loop; the s-vector products are fused with
        # their scaling below, so only the challenges are materialised here)
        lg_n = len(self.vec_L_C)
        if lg_n >= 32 or n != (1 << lg_n):
            raise VerificationError("bad IPA proof shape")
        challenges = []
        for i in range(lg_n):
            transcript.append_points(
                b"ipa_loop",
                [self.vec_L_C[i], self.vec_L_D[i],
                 self.vec_R_C[i], self.vec_R_D[i]])
            challenges.append(transcript.get_and_append_challenge(b"ipa_gamma"))
        challenges_inv = batch_inversion(challenges, R)
        vec_gamma, vec_gamma_inv = challenges, challenges_inv

        vec_G_H = list(crs_G_vec) + [crs_H]

        # Step 3: first accumulated check (C-side). The whole relation
        #   gamma x L_C + (B_c + alpha C + alpha^2 z beta H) + gamma^-1 x R_C
        #     == <rhs, G||H>
        # enters the accumulator in zero form — no eager group math at all
        # (the reference computes the lhs eagerly, inner_product_argument.rs
        # :294-309; here even C's alpha-mul and H's beta-mul are deferred).
        # rhs_i = c_final * s_i, negated.
        a2zb = alpha * alpha % R * z % R * beta % R
        lhs_x = vec_gamma + [1, alpha, a2zb] + vec_gamma_inv
        lhs_V = self.vec_L_C + [self.B_c, C, crs_H] + self.vec_R_C
        neg_rhs = scaled_verification_products(
            challenges, n, cmul=self.c_final, neg=True, raw=True)
        tail = -(self.c_final * self.d_final % R * beta) % R
        msm_accumulator.accumulate_zero(FrVec(lhs_x, neg_rhs, [tail]),
                                        lhs_V + vec_G_H, rng)

        # second accumulated check (D-side): rhs_i = d_final * inv_s_i * u_i
        lhs_x = vec_gamma + [1, alpha] + vec_gamma_inv
        lhs_V = self.vec_L_D + [self.B_d, D] + self.vec_R_D
        neg_rhs = scaled_verification_products(
            challenges_inv, n, cmul=self.d_final, mulvec=vec_u, neg=True,
            raw=True)
        msm_accumulator.accumulate_zero(FrVec(lhs_x, neg_rhs),
                                        lhs_V + list(crs_G_vec), rng)

    # --- serde (layout: inner_product_argument.rs:328-351) --------------------
    def serialize(self) -> bytes:
        out = bytearray()
        out += g1_to_bytes(self.B_c)
        out += g1_to_bytes(self.B_d)
        for vec in (self.vec_L_C, self.vec_R_C, self.vec_L_D, self.vec_R_D):
            for p in vec:
                out += g1_to_bytes(p)
        out += fr_to_bytes(self.c_final)
        out += fr_to_bytes(self.d_final)
        return bytes(out)

    @staticmethod
    def deserialize(buf: memoryview, log2_n: int) -> tuple["InnerProductProof", memoryview]:
        def take(n):
            nonlocal buf
            chunk, buf = buf[:n], buf[n:]
            return bytes(chunk)

        # one batch decompress for the whole 2 + 4*log2_n point run
        pts = g1_from_bytes_batch(
            [take(48) for _ in range(2 + 4 * log2_n)])
        B_c, B_d = pts[0], pts[1]
        vecs = [pts[2 + i * log2_n : 2 + (i + 1) * log2_n] for i in range(4)]
        c_final = fr_from_bytes(take(32))
        d_final = fr_from_bytes(take(32))
        return InnerProductProof(B_c, B_d, vecs[0], vecs[1], vecs[2], vecs[3],
                                 c_final, d_final), buf
