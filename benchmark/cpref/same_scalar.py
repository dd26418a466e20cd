"""Same scalar argument (parity: `curdleproofs/src/same_scalar_argument.rs`).

Sigma-protocol proving cm_T, cm_U commit to k*R, k*S under the same scalar k.
Verified eagerly when no accumulator is passed (the reference always does);
with one, its four linear checks join the single deferred MSM.
"""

from __future__ import annotations

from .commitments import GroupCommitment
from .constants import R
from .errors import VerificationError
from .host.g1 import G1
from .host.rng import StdRng
from .host.serde import (
    fr_from_bytes, fr_to_bytes, g1_from_bytes_batch, g1_to_bytes,
)
from .msm_accumulator import MsmAccumulator
from .transcript import Transcript

__all__ = ["SameScalarProof"]


class SameScalarProof:
    __slots__ = ("cm_A", "cm_B", "z_k", "z_t", "z_u")

    def __init__(self, cm_A: GroupCommitment, cm_B: GroupCommitment,
                 z_k: int, z_t: int, z_u: int):
        self.cm_A = cm_A
        self.cm_B = cm_B
        self.z_k = z_k
        self.z_t = z_t
        self.z_u = z_u

    @staticmethod
    def new(
        crs_G_t: G1,
        crs_G_u: G1,
        crs_H: G1,
        R_pt: G1,
        S_pt: G1,
        cm_T: GroupCommitment,
        cm_U: GroupCommitment,
        k: int,
        r_t: int,
        r_u: int,
        transcript: Transcript,
        rng: StdRng,
    ) -> "SameScalarProof":
        # Step 1
        r_a = rng.rand_fr()
        r_b = rng.rand_fr()
        r_k = rng.rand_fr()

        cm_A = GroupCommitment.new(crs_G_t, crs_H, R_pt.mul(r_k), r_a)
        cm_B = GroupCommitment.new(crs_G_u, crs_H, S_pt.mul(r_k), r_b)

        transcript.append_points(b"sameexp_points", [
            R_pt, S_pt, cm_T.T_1, cm_T.T_2, cm_U.T_1, cm_U.T_2,
            cm_A.T_1, cm_A.T_2, cm_B.T_1, cm_B.T_2])
        alpha = transcript.get_and_append_challenge(b"same_scalar_alpha")

        # Step 2
        z_k = (r_k + k * alpha) % R
        z_t = (r_a + r_t * alpha) % R
        z_u = (r_b + r_u * alpha) % R

        return SameScalarProof(cm_A, cm_B, z_k, z_t, z_u)

    def verify(
        self,
        crs_G_t: G1,
        crs_G_u: G1,
        crs_H: G1,
        R_pt: G1,
        S_pt: G1,
        cm_T: GroupCommitment,
        cm_U: GroupCommitment,
        transcript: Transcript,
        msm_accumulator: MsmAccumulator | None = None,
        rng: StdRng | None = None,
    ) -> None:
        """Verify `cm_A + alpha*cm_T == Com(z_k*R, z_t)` (and the U twin).

        With an accumulator, the four linear component equations join the
        one deferred MSM under fresh random weights — 10 scalar muls saved
        per proof.  (Deviation from the reference, which always checks this
        sub-argument eagerly, same_scalar_argument.rs:129-136; soundness is
        the same random-linear-combination argument the accumulator already
        rests on.)  Without an accumulator the eager path runs as upstream.
        """
        transcript.append_points(b"sameexp_points", [
            R_pt, S_pt, cm_T.T_1, cm_T.T_2, cm_U.T_1, cm_U.T_2,
            self.cm_A.T_1, self.cm_A.T_2, self.cm_B.T_1, self.cm_B.T_2])
        alpha = transcript.get_and_append_challenge(b"same_scalar_alpha")

        if msm_accumulator is not None and rng is not None:
            neg = -1 % R
            for (lhs1, lhs2, zk_base, com_g, zr) in (
                    (self.cm_A, cm_T, R_pt, crs_G_t, self.z_t),
                    (self.cm_B, cm_U, S_pt, crs_G_u, self.z_u)):
                # T_1 part: lhs1.T_1 + alpha*lhs2.T_1 == zr * com_g
                msm_accumulator.accumulate_zero(
                    [1, alpha, zr * neg % R],
                    [lhs1.T_1, lhs2.T_1, com_g], rng)
                # T_2 part: lhs1.T_2 + alpha*lhs2.T_2 == z_k*base + zr*H
                msm_accumulator.accumulate_zero(
                    [1, alpha, self.z_k * neg % R, zr * neg % R],
                    [lhs1.T_2, lhs2.T_2, zk_base, crs_H], rng)
            return

        expected_1 = GroupCommitment.new(crs_G_t, crs_H, R_pt.mul(self.z_k), self.z_t)
        expected_2 = GroupCommitment.new(crs_G_u, crs_H, S_pt.mul(self.z_k), self.z_u)

        if not (self.cm_A + cm_T.mul(alpha) == expected_1
                and self.cm_B + cm_U.mul(alpha) == expected_2):
            raise VerificationError("same-scalar check failed")

    # --- serde (derived CanonicalSerialize: cm_A, cm_B, z_k, z_t, z_u) --------
    def serialize(self) -> bytes:
        return (g1_to_bytes(self.cm_A.T_1) + g1_to_bytes(self.cm_A.T_2)
                + g1_to_bytes(self.cm_B.T_1) + g1_to_bytes(self.cm_B.T_2)
                + fr_to_bytes(self.z_k) + fr_to_bytes(self.z_t) + fr_to_bytes(self.z_u))

    @staticmethod
    def deserialize(buf: memoryview) -> tuple["SameScalarProof", memoryview]:
        pts = g1_from_bytes_batch(
            [bytes(buf[48 * i : 48 * (i + 1)]) for i in range(4)])
        cm_A = GroupCommitment(pts[0], pts[1])
        cm_B = GroupCommitment(pts[2], pts[3])
        z_k = fr_from_bytes(bytes(buf[192:224]))
        z_t = fr_from_bytes(bytes(buf[224:256]))
        z_u = fr_from_bytes(bytes(buf[256:288]))
        return SameScalarProof(cm_A, cm_B, z_k, z_t, z_u), buf[288:]
