"""Same multiscalar argument (parity: `curdleproofs/src/same_multiscalar_argument.rs`).

IPA-style recursive argument that one private vector x satisfies
A = <x, G>, Z_t = <x, T>, Z_u = <x, U> simultaneously; log n rounds each
emitting 6 points, O(n) verifier with 3 accumulated MSM checks.
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
    FrVec, generate_blinders, scaled_verification_products,
    verification_scalar_products,
)

__all__ = ["SameMultiscalarProof"]


class SameMultiscalarProof:
    __slots__ = ("B_a", "B_t", "B_u", "vec_L_A", "vec_L_T", "vec_L_U",
                 "vec_R_A", "vec_R_T", "vec_R_U", "x_final")

    def __init__(self, B_a, B_t, B_u, vec_L_A, vec_L_T, vec_L_U,
                 vec_R_A, vec_R_T, vec_R_U, x_final):
        self.B_a = B_a
        self.B_t = B_t
        self.B_u = B_u
        self.vec_L_A = vec_L_A
        self.vec_L_T = vec_L_T
        self.vec_L_U = vec_L_U
        self.vec_R_A = vec_R_A
        self.vec_R_T = vec_R_T
        self.vec_R_U = vec_R_U
        self.x_final = x_final

    @staticmethod
    def new(
        crs_G_vec: list[G1],
        A: G1,
        Z_t: G1,
        Z_u: G1,
        vec_T: list[G1],
        vec_U: list[G1],
        vec_x: list[int],
        transcript: Transcript,
        rng: StdRng,
    ) -> "SameMultiscalarProof":
        n = len(vec_x)
        backend = get_backend()
        vec_G = list(crs_G_vec)
        vec_T = list(vec_T)
        vec_U = list(vec_U)

        backend = get_backend()
        vec_r = generate_blinders(rng, n)
        B_a, B_t, B_u = backend.msm_many(
            [(vec_G, vec_r), (vec_T, vec_r), (vec_U, vec_r)])

        transcript.append_points(b"same_msm_step1", [A, Z_t, Z_u])
        transcript.append_point_vec(b"same_msm_step1", vec_T)
        transcript.append_point_vec(b"same_msm_step1", vec_U)
        transcript.append_points(b"same_msm_step1", [B_a, B_t, B_u])
        alpha = transcript.get_and_append_challenge(b"same_msm_alpha")

        vec_x = [(r + alpha * x) % R for r, x in zip(vec_r, vec_x)]

        vec_L_A, vec_L_T, vec_L_U = [], [], []
        vec_R_A, vec_R_T, vec_R_U = [], [], []

        while len(vec_x) > 1:
            half = len(vec_x) // 2
            x_L, x_R = vec_x[:half], vec_x[half:]
            T_L, T_R = vec_T[:half], vec_T[half:]
            U_L, U_R = vec_U[:half], vec_U[half:]
            G_L, G_R = vec_G[:half], vec_G[half:]

            L_A, L_T, L_U, R_A, R_T, R_U = backend.msm_many(
                [(G_R, x_L), (T_R, x_L), (U_R, x_L),
                 (G_L, x_R), (T_L, x_R), (U_L, x_R)])

            vec_L_A.append(L_A)
            vec_L_T.append(L_T)
            vec_L_U.append(L_U)
            vec_R_A.append(R_A)
            vec_R_T.append(R_T)
            vec_R_U.append(R_U)

            transcript.append_points(b"same_msm_loop",
                                     [L_A, L_T, L_U, R_A, R_T, R_U])
            gamma = transcript.get_and_append_challenge(b"same_msm_gamma")
            gamma_inv = fr_inv(gamma)

            vec_x = [(l + gamma_inv * r) % R for l, r in zip(x_L, x_R)]
            # T, U, G all fold by the same gamma -> one concatenated call
            folded = backend.fold_points(T_L + U_L + G_L, T_R + U_R + G_R,
                                         gamma)
            vec_T = folded[:half]
            vec_U = folded[half : 2 * half]
            vec_G = folded[2 * half :]

        return SameMultiscalarProof(B_a, B_t, B_u, vec_L_A, vec_L_T, vec_L_U,
                                    vec_R_A, vec_R_T, vec_R_U, vec_x[0])

    def verification_scalars(self, n: int, transcript: Transcript):
        lg_n = len(self.vec_L_A)
        if lg_n >= 32 or n != (1 << lg_n):
            raise VerificationError("bad SameMsm proof shape")

        challenges = []
        for i in range(lg_n):
            transcript.append_points(b"same_msm_loop", [
                self.vec_L_A[i], self.vec_L_T[i], self.vec_L_U[i],
                self.vec_R_A[i], self.vec_R_T[i], self.vec_R_U[i]])
            challenges.append(transcript.get_and_append_challenge(b"same_msm_gamma"))

        challenges_inv = batch_inversion(challenges, R)
        # one mul per entry (same_multiscalar_argument.rs:225-236 semantics)
        vec_s = verification_scalar_products(challenges, n)
        return challenges, challenges_inv, vec_s

    def verify(
        self,
        crs_G_vec: list[G1],
        A: G1,
        Z_t: G1,
        Z_u: G1,
        vec_T: list[G1],
        vec_U: list[G1],
        transcript: Transcript,
        msm_accumulator: MsmAccumulator,
        rng: StdRng,
    ) -> None:
        n = len(vec_T)

        transcript.append_points(b"same_msm_step1", [A, Z_t, Z_u])
        transcript.append_point_vec(b"same_msm_step1", vec_T)
        transcript.append_point_vec(b"same_msm_step1", vec_U)
        transcript.append_points(b"same_msm_step1", [self.B_a, self.B_t, self.B_u])
        alpha = transcript.get_and_append_challenge(b"same_msm_alpha")

        lg_n = len(self.vec_L_A)
        if lg_n >= 32 or n != (1 << lg_n):
            raise VerificationError("bad SameMsm proof shape")
        vec_gamma = []
        for i in range(lg_n):
            transcript.append_points(b"same_msm_loop", [
                self.vec_L_A[i], self.vec_L_T[i], self.vec_L_U[i],
                self.vec_R_A[i], self.vec_R_T[i], self.vec_R_U[i]])
            vec_gamma.append(
                transcript.get_and_append_challenge(b"same_msm_gamma"))
        vec_gamma_inv = batch_inversion(vec_gamma, R)

        # all three relations enter the accumulator in zero form — the
        # reference computes each lhs eagerly (same_multiscalar_argument.rs
        # :249-259); here the gamma-folded L/R terms and the alpha-muls all
        # ride the single deduped MSM. rhs_i = x_final * s_i, negated
        # (shared by the three relations).
        neg_rhs = FrVec(scaled_verification_products(
            vec_gamma, n, cmul=self.x_final, neg=True, raw=True))
        lhs_x = FrVec(vec_gamma + [1, alpha] + vec_gamma_inv)
        for L, R_, B_pt, C_pt, bases in (
                (self.vec_L_A, self.vec_R_A, self.B_a, A, crs_G_vec),
                (self.vec_L_T, self.vec_R_T, self.B_t, Z_t, vec_T),
                (self.vec_L_U, self.vec_R_U, self.B_u, Z_u, vec_U)):
            # lhs_x / neg_rhs FrVecs serialise once and are shared by the
            # three relations' dedup jobs
            lhs_V = L + [B_pt, C_pt] + R_
            msm_accumulator.accumulate_zero(FrVec(lhs_x, neg_rhs),
                                            lhs_V + list(bases), rng)

    # --- serde (same_multiscalar_argument.rs:263-289) ---------------------------
    def serialize(self) -> bytes:
        out = bytearray()
        for p in (self.B_a, self.B_t, self.B_u):
            out += g1_to_bytes(p)
        for vec in (self.vec_L_A, self.vec_L_T, self.vec_L_U,
                    self.vec_R_A, self.vec_R_T, self.vec_R_U):
            for p in vec:
                out += g1_to_bytes(p)
        out += fr_to_bytes(self.x_final)
        return bytes(out)

    @staticmethod
    def deserialize(buf: memoryview, log2_n: int) -> tuple["SameMultiscalarProof", memoryview]:
        def take(n):
            nonlocal buf
            chunk, buf = buf[:n], buf[n:]
            return bytes(chunk)

        # one batch decompress for the whole 3 + 6*log2_n point run
        pts = g1_from_bytes_batch(
            [take(48) for _ in range(3 + 6 * log2_n)])
        B_a, B_t, B_u = pts[0], pts[1], pts[2]
        vecs = [pts[3 + i * log2_n : 3 + (i + 1) * log2_n] for i in range(6)]
        x_final = fr_from_bytes(take(32))
        return SameMultiscalarProof(B_a, B_t, B_u, *vecs, x_final), buf
