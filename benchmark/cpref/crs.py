"""The Curdleproofs CRS (parity: `curdleproofs/src/crs.rs`).

`from_points` and the seeded dev CRS (`StdRng::seed_from_u64(0)`).
"""

from __future__ import annotations

import math

from .constants import CRS_EXTRA_POINTS, N_BLINDERS
from .host.g1 import G1
from .host.rng import StdRng
from .util import sum_affine_points

__all__ = ["CurdleproofsCrs"]


class CurdleproofsCrs:
    __slots__ = ("vec_G", "vec_H", "H", "G_t", "G_u", "G_sum", "H_sum")

    def __init__(self, vec_G, vec_H, H, G_t, G_u, G_sum, H_sum):
        self.vec_G = vec_G
        self.vec_H = vec_H
        self.H = H
        self.G_t = G_t
        self.G_u = G_u
        self.G_sum = G_sum
        self.H_sum = H_sum

    @staticmethod
    def from_points(ell: int, points: list[G1]) -> "CurdleproofsCrs":
        n = ell + N_BLINDERS
        num_points = n + CRS_EXTRA_POINTS
        if len(points) < num_points:
            raise ValueError("not enough points")
        vec_G = points[:ell]
        vec_H = points[ell:n]
        return CurdleproofsCrs(
            vec_G=vec_G,
            vec_H=vec_H,
            H=points[n],
            G_t=points[n + 1],
            G_u=points[n + 2],
            G_sum=sum_affine_points(vec_G),
            H_sum=sum_affine_points(vec_H),
        )

    @staticmethod
    def generate_crs(ell: int) -> "CurdleproofsCrs":
        """Unsafe dev CRS from StdRng(0) — bit-exact with crs.rs:61-69."""
        num_points = ell + N_BLINDERS + CRS_EXTRA_POINTS
        rng = StdRng.seed_from_u64(0)
        points = [rng.rand_g1() for _ in range(num_points)]
        return CurdleproofsCrs.from_points(ell, points)

    def log2_n(self) -> int:
        n = len(self.vec_H) + len(self.vec_G)
        return math.ceil(math.log2(n))
