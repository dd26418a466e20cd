"""Where the protocol's vector point arithmetic runs.

Every MSM, batched scalar multiplication and point fold of the protocol
goes through the active backend; `HostBackend` runs them in `plain.c`
(one bucket-method MSM, double-and-add scalar multiplications).  A
control swaps in a backend with a guarantee broken (`use_backend`).
"""

from __future__ import annotations

from .host import plain
from .host.g1 import G1

__all__ = ["Backend", "HostBackend", "get_backend", "set_backend", "use_backend"]


class Backend:
    """Interface: all inputs/outputs are host `G1` objects / int scalars."""

    name = "abstract"

    def msm(self, points: list[G1], scalars: list[int]) -> G1:
        raise NotImplementedError

    def msm_many(self, groups: list[tuple[list[G1], list[int]]]) -> list[G1]:
        """Independent MSMs, e.g. the L/R commitments of one folding round."""
        return [self.msm(p, s) for p, s in groups]

    def batch_mul_each(self, points: list[G1], scalars: list[int]) -> list[G1]:
        """[s_i * P_i] (e.g. grand-product basis rescaling)."""
        raise NotImplementedError

    def batch_mul(self, points: list[G1], scalar: int) -> list[G1]:
        """[scalar * P for P in points]"""
        return self.batch_mul_each(points, [scalar] * len(points))

    def fold_points_each(self, left: list[G1], right: list[G1],
                         scalars: list[int]) -> list[G1]:
        """[L_i + s_i * R_i] with per-point scalars."""
        raise NotImplementedError

    def fold_points(self, left: list[G1], right: list[G1], gamma: int) -> list[G1]:
        """[L_i + gamma * R_i] — the recursive-argument folding step."""
        return self.fold_points_each(left, right, [gamma] * len(left))


class HostBackend(Backend):
    """The plain C arithmetic of `host/plain.c`."""

    name = "host"

    def msm(self, points: list[G1], scalars: list[int]) -> G1:
        assert len(points) == len(scalars)
        return plain.msm(points, scalars) if points else G1.infinity()

    def batch_mul_each(self, points: list[G1], scalars: list[int]) -> list[G1]:
        return plain.mul_each(points, scalars) if points else []

    def fold_points_each(self, left: list[G1], right: list[G1],
                         scalars: list[int]) -> list[G1]:
        return plain.fold_each(left, right, scalars) if left else []


_active: Backend | None = None


def get_backend() -> Backend:
    global _active
    if _active is None:
        _active = HostBackend()
    return _active


def set_backend(backend: Backend) -> None:
    global _active
    _active = backend


class use_backend:
    """Context manager to swap the active backend temporarily."""

    def __init__(self, backend: Backend):
        self._new = backend
        self._old: Backend | None = None

    def __enter__(self):
        global _active
        self._old = _active
        _active = self._new
        return self._new

    def __exit__(self, *exc):
        global _active
        _active = self._old
        return False
