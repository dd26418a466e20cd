"""Pluggable compute backend for the O(n) group math.

Plays the role of the reference's rayon `parallel` feature (Cargo.toml:34,37):
the one switch that decides where every hot vector primitive runs.

The protocol layer is backend-agnostic: every hot vector primitive (MSM, batched
scalar-mul, point folding) dispatches through the active backend. `HostBackend`
is the latency-optimal native/Python path for small n and the golden model;
`TorchBackend`, `HybridBackend` and `DeviceBackend` (in
`curdleproofs_tpu_torch.ops.backend`) run MSMs, and the last also the
ladders, on a CUDA card through the hand-written kernels.
"""

from __future__ import annotations

from .host.g1 import G1
from .utils.trace import span

__all__ = ["Backend", "HostBackend", "get_backend", "set_backend", "use_backend"]


class Backend:
    """Interface: all inputs/outputs are host `G1` objects / int scalars.

    `native_prove_loops`: whether the provers run all of a folding
    argument's rounds in one native call (`ipa.py`, `same_msm.py`) when the
    library and a native transcript are there, as the reference does under
    every backend.  Bit-identical either way; a backend that wants the
    rounds' MSMs and folds dispatched through it turns it off."""

    name = "abstract"
    native_prove_loops = True

    def msm(self, points: list[G1], scalars: list[int]) -> G1:
        raise NotImplementedError

    def msm_raw(self, points: list[G1], sbytes: bytes) -> G1:
        """MSM with scalars as canonical 32 B-LE bytes (the verifier's fused
        dedup layout). Backends override to skip the int round trip.

        The length check is a hard raise (NOT an assert): a short buffer
        would silently read missing scalars as 0, and a zero-heavy MSM
        trends toward infinity — the accumulated check would fail OPEN."""
        n = len(points)
        if len(sbytes) != 32 * n:
            raise ValueError(
                f"scalar buffer is {len(sbytes)} B for {n} points")
        return self.msm(points, [
            int.from_bytes(sbytes[i * 32:(i + 1) * 32], "little")
            for i in range(n)])

    def batch_mul(self, points: list[G1], scalar: int) -> list[G1]:
        """[scalar * P for P in points]"""
        raise NotImplementedError

    def fold_points(self, left: list[G1], right: list[G1], gamma: int) -> list[G1]:
        """[L_i + gamma * R_i] — the recursive-argument folding step."""
        raise NotImplementedError

    def batch_mul_each(self, points: list[G1], scalars: list[int]) -> list[G1]:
        """[s_i * P_i] (e.g. grand-product basis rescaling)."""
        raise NotImplementedError

    def msm_many(self, groups: list[tuple[list[G1], list[int]]]) -> list[G1]:
        """Independent MSMs, e.g. the 4-6 L/R commitments of one folding
        round; backends may batch them into one pass."""
        return [self.msm(p, s) for p, s in groups]

    def fold_points_each(self, left: list[G1], right: list[G1],
                         scalars: list[int]) -> list[G1]:
        """[L_i + s_i * R_i] with per-point scalars (e.g. the IPA round's
        gamma/gamma_inv fold pair concatenated into one call)."""
        return [l.add(r.mul(s)) for l, r, s in zip(left, right, scalars)]


class HostBackend(Backend):
    """Host path: native C++ (64-bit-limb Montgomery) when built, Python ints
    otherwise. Latency-optimal for small n; the golden model either way."""

    name = "host"

    def __init__(self, allow_native: bool = True):
        self._native = None
        if allow_native:
            try:
                from .host import native

                if native.available():
                    self._native = native
            except Exception:
                self._native = None

    def msm(self, points: list[G1], scalars: list[int]) -> G1:
        if not points:
            return G1.infinity()
        if self._native is not None and len(points) >= 2:
            with span("host.msm", timeline=False, terms=len(points)):
                return self._native.msm(points, scalars)
        return _pippenger(points, scalars)

    def msm_raw(self, points: list[G1], sbytes: bytes) -> G1:
        if not points:
            return G1.infinity()
        if self._native is not None and len(points) >= 2:
            with span("host.msm", timeline=False, terms=len(points)):
                return self._native.msm_scalars_raw(points, sbytes)
        return super().msm_raw(points, sbytes)

    def batch_mul(self, points: list[G1], scalar: int) -> list[G1]:
        if self._native is not None and points:
            return self._native.batch_mul_glv(points, scalar)
        return [p.mul(scalar) for p in points]

    def batch_mul_each(self, points: list[G1], scalars: list[int]) -> list[G1]:
        if self._native is not None and points:
            return self._native.batch_mul_each_glv(points, scalars)
        return [p.mul(s) for p, s in zip(points, scalars)]

    def fold_points(self, left: list[G1], right: list[G1], gamma: int) -> list[G1]:
        if self._native is not None and left:
            return self._native.fold_glv(left, right, gamma)
        return [l.add(r.mul(gamma)) for l, r in zip(left, right)]

    def msm_many(self, groups: list[tuple[list[G1], list[int]]]) -> list[G1]:
        if self._native is not None and sum(len(p) for p, _ in groups) >= 8:
            with span("host.msm", timeline=False, msms=len(groups)):
                return self._native.msm_many(groups)
        return [self.msm(p, s) for p, s in groups]

    def fold_points_each(self, left: list[G1], right: list[G1],
                         scalars: list[int]) -> list[G1]:
        if self._native is not None and len(left) >= 4:
            return self._native.fold_each_glv(left, right, scalars)
        return [l.add(r.mul(s)) for l, r, s in zip(left, right, scalars)]


class PurePythonBackend(HostBackend):
    """Reference Python-int path (no native lib) — the test golden model."""

    name = "pure-python"

    def __init__(self):
        super().__init__(allow_native=False)


def _pippenger(points: list[G1], scalars: list[int], window: int | None = None) -> G1:
    """Bucketed MSM over host ints (the device twin lives in ops/msm.py)."""
    assert len(points) == len(scalars)
    n = len(points)
    if n == 0:
        return G1.infinity()
    if n == 1:
        return points[0].mul(scalars[0])
    if window is None:
        window = max(3, n.bit_length() - 2)
        window = min(window, 13)
    nbits = 255
    acc = G1.infinity()
    for w_start in range(((nbits + window - 1) // window) * window - window, -1, -window):
        for _ in range(window):
            acc = acc.double()
        buckets: dict[int, G1] = {}
        mask = (1 << window) - 1
        for p, s in zip(points, scalars):
            digit = (s >> w_start) & mask
            if digit:
                cur = buckets.get(digit)
                buckets[digit] = p if cur is None else cur.add(p)
        if not buckets:
            continue
        running = G1.infinity()
        window_sum = G1.infinity()
        for digit in range(max(buckets), 0, -1):
            b = buckets.get(digit)
            if b is not None:
                running = running.add(b)
            window_sum = window_sum.add(running)
        acc = acc.add(window_sum)
    return acc


def _backend_from_env() -> Backend:
    """Resolve CURDLEPROOFS_BACKEND: torch (the default) | host | tpu |
    hybrid | pure | auto, the reference's names plus the port's `torch`.

    `torch` is `TorchBackend`, `hybrid` `HybridBackend`, `tpu` the
    all-device `DeviceBackend` (the reference's `TpuBackend`), `auto`
    `auto_backend()`, which is `HybridBackend`; each runs on `cuda` and
    raises when no card is present (the reference's `auto` falls back to
    the host there), so a program that wants the CPU says so (`host`/`pure`,
    or `set_backend`/`use_backend` with a CPU backend).  An unknown name
    raises."""
    import os

    name = os.environ.get("CURDLEPROOFS_BACKEND", "torch").lower()
    if name == "host":
        return HostBackend()
    if name in ("pure", "python", "pure-python"):
        return PurePythonBackend()
    if name not in ("torch", "hybrid", "tpu", "auto"):
        raise ValueError(f"unknown CURDLEPROOFS_BACKEND={name!r}")
    from .ops import backend as ops_backend

    return {"torch": ops_backend.TorchBackend,
            "hybrid": ops_backend.HybridBackend,
            "tpu": ops_backend.DeviceBackend,
            "auto": ops_backend.auto_backend}[name]()


_active: Backend | None = None


def get_backend() -> Backend:
    # resolved lazily (not at import): importing the package never touches
    # the card
    global _active
    if _active is None:
        _active = _backend_from_env()
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
