"""Device backends: route the protocol's group math through the torch
Pippenger pipeline, the ladder kernel and their CUDA kernels.

Implements the `curdleproofs_tpu_torch.backend.Backend` interface three
ways, the JAX package's `ops/backend.py` and the port's default:
- `TorchBackend` (the default; `CURDLEPROOFS_BACKEND=torch`): `msm`,
  `msm_raw` and `msm_many` on the device for n >= `MIN_DEVICE_SIZE` points;
  below that, and for the latency ops `batch_mul`, `batch_mul_each`,
  `fold_points` and `fold_points_each`, the native host runtime.  The fused
  native prove loops stay off, so the folding rounds' MSMs reach the card.
- `HybridBackend` (`hybrid`, and `auto` on the card): the reference's
  production mode.  Every MSM goes where the measured crossover says
  (`ops/msm_tune.py::route_to_device`, the table for this device's type),
  untuned where the reference's fallback says; every other op runs on the
  host, the fused loops included.
- `DeviceBackend` (`tpu`): the reference's all-device `TpuBackend`: MSMs as
  `TorchBackend`, and `batch_mul`, `batch_mul_each` and `fold_points`
  through the ladder kernel (`ops/msm.py`), from `MIN_DEVICE_SIZE` points.
`engine_counts` counts MSMs by engine, `last_msm_engine` names the last.
"""

from __future__ import annotations

from ..backend import Backend, HostBackend, get_backend
from ..constants import R
from ..host.g1 import G1
from ..utils.trace import span
from . import msm
from .device import resolve_device
from .g1_ops import points_from_device, points_to_device
from .limbs import ints_to_bits

__all__ = ["TorchBackend", "HybridBackend", "DeviceBackend", "auto_backend",
           "active_device"]


class TorchBackend(Backend):
    name = "torch"
    MIN_DEVICE_SIZE = 8  # below this the host runtime wins on latency
    native_prove_loops = False

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.engine_counts = {"device": 0, "host": 0}
        self.last_msm_engine: str | None = None
        self._host = HostBackend()

    def _wants_device(self, points: list[G1]) -> bool:
        return len(points) >= self.MIN_DEVICE_SIZE

    def _on_device(self, points: list[G1]) -> bool:
        engine = "device" if self._wants_device(points) else "host"
        self.engine_counts[engine] += 1
        self.last_msm_engine = engine
        return engine == "device"

    # --- MSMs --------------------------------------------------------------
    def msm(self, points: list[G1], scalars: list[int]) -> G1:
        if not points:
            return G1.infinity()
        if not self._on_device(points):
            with span("msm.host", timeline=False, terms=len(points)):
                return self._host.msm(points, scalars)
        from .msm_device import msm_device

        with span("msm.device", terms=len(points)):
            return msm_device(points, list(scalars), device=self.device)

    def msm_raw(self, points: list[G1], sbytes: bytes) -> G1:
        n = len(points)
        if len(sbytes) != 32 * n:
            raise ValueError(f"scalar buffer is {len(sbytes)} B for {n} points")
        if n == 0:
            return G1.infinity()
        if not self._on_device(points):
            with span("msm.host", timeline=False, terms=n):
                return self._host.msm_raw(points, sbytes)
        from .msm_device import msm_device

        with span("msm.device", terms=n):
            return msm_device(points, bytes(sbytes), device=self.device)

    # --- latency ops: the native host runtime ------------------------------
    def batch_mul(self, points: list[G1], scalar: int) -> list[G1]:
        return self._host.batch_mul(points, scalar)

    def batch_mul_each(self, points: list[G1], scalars: list[int]) -> list[G1]:
        return self._host.batch_mul_each(points, scalars)

    def fold_points(self, left: list[G1], right: list[G1], gamma: int) -> list[G1]:
        return self._host.fold_points(left, right, gamma)

    def fold_points_each(self, left: list[G1], right: list[G1],
                         scalars: list[int]) -> list[G1]:
        return self._host.fold_points_each(left, right, scalars)


class HybridBackend(TorchBackend):
    """Latency ops on the native host runtime; MSMs on the device where the
    measured crossover puts them (the JAX package's `HybridBackend`,
    curdleproofs_tpu/ops/backend.py:22-96).

    The protocol's folding rounds and small sub-argument MSMs are
    latency-bound (the host C++ wins, and the fused prove loops run there);
    the verifier's one big deduped MSM and anything batch-scale is
    throughput-bound (the device wins)."""

    name = "hybrid"
    native_prove_loops = True
    DEVICE_MSM_THRESHOLD = 1 << 16  # untuned: resident bases from here

    def _wants_device(self, points: list[G1]) -> bool:
        """One routing decision for msm AND msm_raw: the measured verdict
        of the tune table for this device's type (the device warm wall, plus
        the fresh-base prep where the bases are not resident on this device
        yet, against the host wall); untuned, the reference's fallback:
        resident bases from `DEVICE_MSM_THRESHOLD` (2^16), fresh ones from
        2^17."""
        from .msm_device import is_resident
        from .msm_tune import route_to_device

        n = len(points)
        resident = is_resident(points, self.device)
        verdict = route_to_device(n, resident, self.device)
        if verdict is not None:
            return verdict
        if n < self.DEVICE_MSM_THRESHOLD:
            return False
        return resident or n >= (1 << 17)

    def msm_many(self, groups: list[tuple[list[G1], list[int]]]) -> list[G1]:
        return self._host.msm_many(groups)


class DeviceBackend(TorchBackend):
    """Every primitive on the device from `MIN_DEVICE_SIZE` points: the
    JAX package's all-device `TpuBackend` (curdleproofs_tpu/ops/
    backend.py:110-161), selected by `CURDLEPROOFS_BACKEND=tpu`.  MSMs run
    as under `TorchBackend`; `batch_mul`, `batch_mul_each` and
    `fold_points` run the ladder kernel (`ops/msm.py`) on points uploaded
    with `points_to_device`; below `MIN_DEVICE_SIZE` points the host
    serves.  `msm_many` and `fold_points_each` take the `Backend`
    defaults, and the fused native prove loops run, as in the reference."""

    name = "device"
    native_prove_loops = True

    def _up(self, points: list[G1]):
        return points_to_device(points, self.device)

    def batch_mul(self, points: list[G1], scalar: int) -> list[G1]:
        if len(points) < self.MIN_DEVICE_SIZE:
            return self._host.batch_mul(points, scalar)
        bits = ints_to_bits([scalar % R], msm.NBITS)[0]
        return points_from_device(msm.batch_mul(self._up(points), bits))

    def batch_mul_each(self, points: list[G1], scalars: list[int]) -> list[G1]:
        if len(points) < self.MIN_DEVICE_SIZE:
            return self._host.batch_mul_each(points, scalars)
        bits = ints_to_bits([s % R for s in scalars], msm.NBITS)
        return points_from_device(msm.batch_mul_each(self._up(points), bits))

    def fold_points(self, left: list[G1], right: list[G1], gamma: int) -> list[G1]:
        if len(left) < self.MIN_DEVICE_SIZE:
            return self._host.fold_points(left, right, gamma)
        bits = ints_to_bits([gamma % R], msm.NBITS)[0]
        return points_from_device(
            msm.fold(self._up(left), self._up(right), bits))

    fold_points_each = Backend.fold_points_each


def auto_backend() -> HybridBackend:
    """`HybridBackend` on the card.  The one deliberate difference from the
    reference, which falls back to the host backend where no TPU is
    present: here, as at every entry point of the port, no card raises."""
    return HybridBackend()


def active_device():
    """The active device backend's device; `cuda` under any other backend
    (which raises without a card, like every entry point).  Where the
    device paths that bypass `msm` (batch verification's stream, the
    batched prover) run."""
    backend = get_backend()
    if isinstance(backend, TorchBackend):
        return backend.device
    return resolve_device("cuda")
