"""Pippenger MSM sharded over a grid of devices: points x windows (the JAX
package's `parallel/sharded_msm.py`).

One process drives a (Dp, Dw) grid of `torch.device`s, as the reference's
`shard_map` runs one program on every device of a `jax.sharding.Mesh`.
Each cell runs the single-MSM pipeline (`ops/msm_device.py`) on its share:

- `points` (data parallel): row i takes the i-th contiguous shard of the
  (point, scalar) pairs.  Window sums are additive across shards, so the
  only traffic is the [3, 24, Wl] window-sum tensor.
- `windows`: column j folds and reduces only its window range
  j * Wl .. (j + 1) * Wl, which cuts both the fold entries and the fixed
  W * B bucket-reduction term by Dw.

EC addition is not an arithmetic all-reduce, so a power-of-two points axis
combines on the devices by a tree of complete adds into row 0 (the
`g1_add` kernel on the card) over the Montgomery window sums; the host
then runs only the W-term Horner.  Other points axes stack the per-shard
canonical sums and add them on the host.

The grid may name one card several times (`[torch.device("cuda", 0)] * k`):
a logical grid, whose cells run one after another on that card.  It runs
the sharded path's window split and points-axis reduce, and measures what
sharding costs, not how it scales.  The CPU tests pass a grid of CPU
devices, where every kernel runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.g1 import G1
from ..ops.g1_ops import PointsXYZ, g1_add, points_to_device
from ..ops.msm_device import (
    _extend_packed, _horner_windows, _leave_montgomery, _pipeline_core,
    _scalars_len, _scalars_to_limbs, _signed_digits, _window_sums_to_host,
    fold_rows_for, slot_bound, use_madd,
)

__all__ = ["MsmMesh", "make_msm_mesh", "sharded_msm_kernel", "sharded_msm"]


class MsmMesh:
    """A (Dp, Dw) grid of torch devices, driven by one process:
    `.devices` is the numpy object array and `.axis_names` the two axes'
    names, as on a `jax.sharding.Mesh`."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, str]):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid of devices, "
                             f"got shape {devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)


def make_msm_mesh(n_devices: int | None = None, n_window_shards: int = 1,
                  axes: tuple[str, str] = ("points", "windows"),
                  devices=None) -> MsmMesh:
    """Mesh of shape (n_devices / n_window_shards, n_window_shards) over
    `devices` (default: every visible card; raises when there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; a CPU grid is "
                               "asked for with devices=[torch.device('cpu')]"
                               " * k")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    dp = len(devs) // n_window_shards
    grid = np.empty((dp, n_window_shards), dtype=object)
    for k in range(dp * n_window_shards):
        grid[k // n_window_shards, k % n_window_shards] = devs[k]
    return MsmMesh(grid, axes)


def _pick_c(n_total: int) -> int:
    return 8 if n_total < (1 << 18) else 16


def _sharded_step(points: list[G1], limbs: np.ndarray, *, mesh: MsmMesh,
                  n_local: int, c: int, w_local: int, t_rows: int,
                  s_pad: int, device_reduce: bool = False,
                  mark=None) -> list[list[torch.Tensor]]:
    """points: n_pad = Dp * n_local host points; limbs: [16, n_pad].

    Returns the per-cell window sums, [3, 24, w_local] canonical projective
    on each cell's device, as rows [Dp][Dw]; with `device_reduce` one row,
    the points axis collapsed into row 0 by a tree of complete adds on the
    devices.  The fold is the one `use_madd()` picks.  `mark(stage)` is
    called as each stage is queued: per cell "i,j start", "i,j upload",
    "i,j recode" and the pipeline's stages under the same prefix, then
    "reduce" after the points-axis reduce."""
    mark = mark or (lambda stage: None)
    devs = mesh.devices
    dp, dw = devs.shape
    madd = use_madd()
    outs = [[None] * dw for _ in range(dp)]
    # queue every cell's work before reading any result back
    for i in range(dp):
        lo, hi = i * n_local, (i + 1) * n_local
        plain = None
        for j in range(dw):
            dev = devs[i, j]
            cell = f"{i},{j}"
            mark(f"{cell} start")
            if plain is None:  # one host conversion a row
                plain = points_to_device(points[lo:hi], dev)
            # the shard extended to packed [P | -P | inf] + liveness bits
            ext_px, ext_py, ext_zb = _extend_packed(
                PointsXYZ(*(t.to(dev) for t in plain)))
            lt = torch.from_numpy(limbs[:, lo:hi].astype(np.int32)).to(dev)
            mark(f"{cell} upload")
            digits = _signed_digits(lt, n_local, c)       # all windows
            mine = digits[j * w_local:(j + 1) * w_local]
            mark(f"{cell} recode")
            outs[i][j] = _pipeline_core(
                ext_px, ext_py, ext_zb, mine, n=n_local, c=c, t_rows=t_rows,
                s_pad=s_pad, madd=madd, to_canonical=not device_reduce,
                mark=lambda stage, cell=cell: mark(f"{cell} {stage}"))
    if not device_reduce:
        return outs
    # reduce the points axis into row 0 in Montgomery form: in step s, each
    # row i with i % 2s == 0 adds row i ^ s's sums, moved to its own device.
    # The reference's SPMD butterfly has every row compute the total; one
    # controller needs only row 0's, in Dp - 1 adds over log2(Dp) steps.
    sums = []
    for j in range(dw):
        acc = [PointsXYZ(*outs[i][j]) for i in range(dp)]
        step = 1
        while step < dp:
            for i in range(0, dp, 2 * step):
                acc[i] = g1_add(acc[i], PointsXYZ(*(t.to(devs[i, j])
                                                    for t in acc[i ^ step])))
            step *= 2
        sums.append(_leave_montgomery(acc[0]))
    mark("reduce")
    return [sums]


def sharded_msm_kernel(mesh: MsmMesh, n_total: int, c: int | None = None):
    """Build a host-facing callable (points, scalars, mark=None) -> G1 for
    fixed sizes.

    `n_total` is padded so every points shard gets the same local size.
    The callable's `mark(stage)`, when given, sees each cell's stages (see
    `_sharded_step`), then "reduce" (power-of-two points axes),
    "download" and "combine" once the host has the result."""
    dp, dw = mesh.devices.shape
    c = c if c is not None else _pick_c(n_total)
    w_total = -(-255 // c)
    if w_total % dw:
        raise ValueError(f"windows axis {dw} must divide W={w_total}")
    w_local = w_total // dw
    n_local = -(-n_total // dp)
    n_local = max(64, -(-n_local // 64) * 64)
    n_pad = n_local * dp
    t_rows = fold_rows_for(n_local, c)
    s_pad = slot_bound(n_local, w_local, c, t_rows)

    # the points axis reduces on the devices whenever it is a power of 2:
    # the host then sees exactly W window sums whatever Dp is
    device_reduce = dp > 1 and (dp & (dp - 1)) == 0

    def run(points: list[G1], scalars: "list[int] | bytes", mark=None) -> G1:
        mark = mark or (lambda stage: None)
        if len(points) > n_pad or _scalars_len(scalars) != len(points):
            raise ValueError(f"{len(points)} points and "
                             f"{_scalars_len(scalars)} scalars for a kernel "
                             f"of {n_pad} slots")
        padded = list(points) + [G1.infinity()] * (n_pad - len(points))
        limbs = _scalars_to_limbs(scalars, n_pad)
        rows = _sharded_step(padded, limbs, mesh=mesh, n_local=n_local, c=c,
                             w_local=w_local, t_rows=t_rows, s_pad=s_pad,
                             device_reduce=device_reduce, mark=mark)
        # host combine: [Rp][Dw] window sums -> W windows -> Horner
        # (Rp = 1 when the points axis was reduced on the devices)
        host = [[_window_sums_to_host(o.cpu().numpy()) for o in row]
                for row in rows]
        mark("download")
        win = [G1.infinity() for _ in range(w_total)]
        for row in host:
            for j, pts in enumerate(row):
                for l, p in enumerate(pts):
                    win[j * w_local + l] = win[j * w_local + l].add(p)
        out = _horner_windows(win, c)
        mark("combine")
        return out

    return run


def sharded_msm(points: list[G1], scalars: "list[int] | bytes",
                mesh: MsmMesh | None = None, c: int | None = None) -> G1:
    """Host-facing sharded MSM: pads, uploads, runs, combines."""
    if mesh is None:
        mesh = make_msm_mesh()
    return sharded_msm_kernel(mesh, len(points), c)(points, scalars)
