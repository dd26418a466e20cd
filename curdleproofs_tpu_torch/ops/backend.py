"""Device backend: routes the protocol's MSMs through the torch Pippenger
pipeline and its CUDA kernels.

Implements the `curdleproofs_tpu_torch.backend.Backend` interface with the
routing of the JAX package's `TpuBackend` (curdleproofs_tpu/ops/backend.py):
`msm`, `msm_raw` and `msm_many` run on the device for n >= `MIN_DEVICE_SIZE`
points; below that, and for the latency ops `batch_mul`, `batch_mul_each`,
`fold_points` and `fold_points_each`, the native host runtime serves, as in
the reference's `HybridBackend`.  `engine_counts` counts MSMs by engine.
"""

from __future__ import annotations

from ..backend import Backend, HostBackend, get_backend
from ..host.g1 import G1
from .device import resolve_device

__all__ = ["TorchBackend", "active_device"]


class TorchBackend(Backend):
    name = "torch"
    MIN_DEVICE_SIZE = 8  # below this the host runtime wins on latency

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.engine_counts = {"device": 0, "host": 0}
        self.last_msm_engine: str | None = None
        self._host = HostBackend()

    def _on_device(self, n: int) -> bool:
        engine = "device" if n >= self.MIN_DEVICE_SIZE else "host"
        self.engine_counts[engine] += 1
        self.last_msm_engine = engine
        return engine == "device"

    # --- MSMs --------------------------------------------------------------
    def msm(self, points: list[G1], scalars: list[int]) -> G1:
        if not points:
            return G1.infinity()
        if not self._on_device(len(points)):
            return self._host.msm(points, scalars)
        from .msm_device import msm_device

        return msm_device(points, list(scalars), device=self.device)

    def msm_raw(self, points: list[G1], sbytes: bytes) -> G1:
        n = len(points)
        if len(sbytes) != 32 * n:
            raise ValueError(f"scalar buffer is {len(sbytes)} B for {n} points")
        if n == 0:
            return G1.infinity()
        if not self._on_device(n):
            return self._host.msm_raw(points, sbytes)
        from .msm_device import msm_device

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


def active_device():
    """The active `TorchBackend`'s device; `cuda` under any other backend
    (which raises without a card, like every entry point).  Where the
    device paths that bypass `msm` (batch verification's stream, the
    batched prover) run."""
    backend = get_backend()
    if isinstance(backend, TorchBackend):
        return backend.device
    return resolve_device("cuda")
