"""Host-side BLS12-381 G1 group arithmetic (Jacobian coordinates, Python ints).

Scalar path + golden model for the device kernels (`curdleproofs_tpu_torch.ops.g1_ops`).
Semantics are value-level-identical to arkworks `ark_ec` short-Weierstrass G1
(reference uses it via `G1Affine`/`G1Projective`); coordinates systems differ
freely since all observable behaviour goes through affine normalisation.
"""

from __future__ import annotations

from ..constants import COFACTOR, CURVE_B, G1_GENERATOR_X, G1_GENERATOR_Y, Q, R
from .field import batch_inversion, fq_sqrt

__all__ = [
    "G1", "INFINITY", "GENERATOR", "g1_generator",
    "get_point_from_x", "get_ys_from_x",
]


class G1:
    """A G1 point in Jacobian coordinates (X, Y, Z); Z == 0 encodes infinity.
    Scalar multiplications by big scalars run in `plain.c`."""

    __slots__ = ("x", "y", "z", "_cb")

    def __init__(self, x: int, y: int, z: int = 1):
        self.x = x
        self.y = y
        self.z = z
        self._cb = None  # cached 48-byte compressed encoding

    # --- constructors -----------------------------------------------------
    @staticmethod
    def infinity() -> "G1":
        return G1(1, 1, 0)

    @staticmethod
    def from_affine(x: int, y: int) -> "G1":
        return G1(x, y, 1)

    def is_infinity(self) -> bool:
        return self.z == 0

    # --- normalisation ----------------------------------------------------
    def to_affine(self) -> tuple[int, int] | None:
        """Return (x, y) affine coordinates, or None for infinity.

        Normalises in place (z -> 1) so repeated serialisation/appends of the
        same object pay the inversion once. Value is unchanged.
        """
        if self.z == 0:
            return None
        if self.z == 1:
            return (self.x, self.y)
        zinv = pow(self.z, -1, Q)
        zinv2 = zinv * zinv % Q
        self.x = self.x * zinv2 % Q
        self.y = self.y * zinv2 % Q * zinv % Q
        self.z = 1
        return (self.x, self.y)

    @staticmethod
    def batch_to_affine(points: list["G1"]) -> list[tuple[int, int] | None]:
        """Normalise many points with a single field inversion."""
        zs = [p.z for p in points]
        zinvs = batch_inversion(zs, Q)
        out: list[tuple[int, int] | None] = []
        for p, zi in zip(points, zinvs):
            if p.z == 0:
                out.append(None)
            else:
                zi2 = zi * zi % Q
                out.append((p.x * zi2 % Q, p.y * zi2 % Q * zi % Q))
        return out

    # --- group law ----------------------------------------------------------
    def double(self) -> "G1":
        if self.z == 0:
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        A = X1 * X1 % Q
        B = Y1 * Y1 % Q
        C = B * B % Q
        D = 2 * ((X1 + B) * (X1 + B) - A - C) % Q
        E = 3 * A % Q
        F = E * E % Q
        X3 = (F - 2 * D) % Q
        Y3 = (E * (D - X3) - 8 * C) % Q
        Z3 = 2 * Y1 * Z1 % Q
        return G1(X3, Y3, Z3)

    def add(self, other: "G1") -> "G1":
        if self.z == 0:
            return other
        if other.z == 0:
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = other.x, other.y, other.z
        Z1Z1 = Z1 * Z1 % Q
        Z2Z2 = Z2 * Z2 % Q
        U1 = X1 * Z2Z2 % Q
        U2 = X2 * Z1Z1 % Q
        S1 = Y1 * Z2 % Q * Z2Z2 % Q
        S2 = Y2 * Z1 % Q * Z1Z1 % Q
        if U1 == U2:
            if S1 != S2:
                return G1.infinity()
            return self.double()
        H = (U2 - U1) % Q
        I = 4 * H * H % Q
        J = H * I % Q
        r = 2 * (S2 - S1) % Q
        V = U1 * I % Q
        X3 = (r * r - J - 2 * V) % Q
        Y3 = (r * (V - X3) - 2 * S1 * J) % Q
        Z3 = 2 * H * Z1 % Q * Z2 % Q
        return G1(X3, Y3, Z3)

    def neg(self) -> "G1":
        if self.z == 0:
            return self
        return G1(self.x, (Q - self.y) % Q, self.z)

    def __add__(self, other: "G1") -> "G1":
        return self.add(other)

    def __sub__(self, other: "G1") -> "G1":
        return self.add(other.neg())

    def __neg__(self) -> "G1":
        return self.neg()

    def mul(self, scalar: int) -> "G1":
        """Scalar multiplication (big scalars in `plain.c`)."""
        s = scalar % R if scalar >= R or scalar < 0 else scalar
        if s == 0 or self.z == 0:
            return G1.infinity()
        if s.bit_length() > 16:
            from . import plain

            return plain.mul_raw(self, s)
        acc = G1.infinity()
        for bit in bin(s)[2:]:
            acc = acc.double()
            if bit == "1":
                acc = acc.add(self)
        return acc

    def mul_bigint(self, scalar: int) -> "G1":
        """Unreduced scalar multiplication (cofactor clearing etc.)."""
        if scalar == 0 or self.z == 0:
            return G1.infinity()
        if scalar.bit_length() > 16:
            from . import plain

            return plain.mul_raw(self, scalar)
        acc = G1.infinity()
        for bit in bin(scalar)[2:]:
            acc = acc.double()
            if bit == "1":
                acc = acc.add(self)
        return acc

    def mul_by_cofactor(self) -> "G1":
        return self.mul_bigint(COFACTOR)

    def is_in_correct_subgroup(self) -> bool:
        return self.mul_bigint(R).is_infinity()

    def is_on_curve(self) -> bool:
        if self.z == 0:
            return True
        aff = self.to_affine()
        x, y = aff
        return (y * y - (x * x % Q * x + CURVE_B)) % Q == 0

    # --- comparison (value-level) ------------------------------------------
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, G1):
            return NotImplemented
        if self.z == 0 or other.z == 0:
            return self.z == 0 and other.z == 0
        # cross-multiply to avoid inversions
        Z1Z1 = self.z * self.z % Q
        Z2Z2 = other.z * other.z % Q
        if (self.x * Z2Z2 - other.x * Z1Z1) % Q != 0:
            return False
        return (self.y * Z2Z2 % Q * other.z - other.y * Z1Z1 % Q * self.z) % Q == 0

    def __hash__(self) -> int:
        aff = self.to_affine()
        return hash(aff)

    def __repr__(self) -> str:
        aff = self.to_affine()
        if aff is None:
            return "G1(infinity)"
        return f"G1(x=0x{aff[0]:x}, y=0x{aff[1]:x})"


INFINITY = G1.infinity()
GENERATOR = G1.from_affine(G1_GENERATOR_X, G1_GENERATOR_Y)

def g1_generator() -> G1:
    return GENERATOR


def get_ys_from_x(x: int) -> tuple[int, int] | None:
    """Return (smaller, larger) y with y^2 = x^3 + b, or None (no square root).

    Ordering matches arkworks `get_ys_from_x_unchecked` (compares canonical ints).
    """
    y = fq_sqrt((x * x % Q * x + CURVE_B) % Q)
    if y is None:
        return None
    ny = (Q - y) % Q
    return (y, ny) if y < ny else (ny, y)


def get_point_from_x(x: int, greatest: bool) -> G1 | None:
    """arkworks `get_point_from_x_unchecked`: pick larger root iff `greatest`."""
    ys = get_ys_from_x(x)
    if ys is None:
        return None
    return G1.from_affine(x, ys[1] if greatest else ys[0])
