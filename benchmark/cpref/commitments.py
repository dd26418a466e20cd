"""ElGamal-style group-element commitment (parity: `curdleproofs/src/commitments.rs`).

GroupCommitment((G, H); T; r) = (r*G, T + r*H); homomorphic under + and scalar *.
"""

from __future__ import annotations

from .host.g1 import G1

__all__ = ["GroupCommitment"]


class GroupCommitment:
    __slots__ = ("T_1", "T_2")

    def __init__(self, T_1: G1, T_2: G1):
        self.T_1 = T_1
        self.T_2 = T_2

    @staticmethod
    def new(crs_G: G1, crs_H: G1, T: G1, r: int) -> "GroupCommitment":
        return GroupCommitment(crs_G.mul(r), T.add(crs_H.mul(r)))

    def __add__(self, other: "GroupCommitment") -> "GroupCommitment":
        return GroupCommitment(self.T_1.add(other.T_1), self.T_2.add(other.T_2))

    def mul(self, scalar: int) -> "GroupCommitment":
        return GroupCommitment(self.T_1.mul(scalar), self.T_2.mul(scalar))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, GroupCommitment):
            return NotImplemented
        return self.T_1 == other.T_1 and self.T_2 == other.T_2

    def __repr__(self) -> str:
        return f"GroupCommitment({self.T_1!r}, {self.T_2!r})"
