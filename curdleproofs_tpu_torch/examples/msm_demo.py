"""Device-MSM quick tour: resident bases, the one-call pipeline, a grid (the
JAX package's `examples/msm_tpu_demo.py`).

    python3 -m curdleproofs_tpu_torch.examples.msm_demo            # the card
    python3 -m curdleproofs_tpu_torch.examples.msm_demo --device cpu \\
        --n 64 --grid 2 1                                         # the CPU

`--device` (default `cuda`, which raises without a card) is where the MSMs
run.  The grid is (points, windows) = `--grid DP DW`; by default (n/2, 2)
over n >= 2 cards, else the (4, 2) grid the JAX demo takes over its eight
virtual CPU devices, every cell on the one device (a logical grid: the
cells run one after another).
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import torch

from ..constants import R
from ..host.rng import StdRng
from ..ops.device import resolve_device
from ..ops.msm_device import msm_device, prepare_bases
from ..parallel.sharded_msm import make_msm_mesh, sharded_msm


def grid_devices(device: torch.device, grid=None) -> tuple[list, int]:
    """(the devices of a grid's cells in row-major order, DW) for `grid`
    (DP, DW), or the default grid, on `device`'s type: the cells cycle
    over the visible cards, or over the one CPU device."""
    if device.type == "cuda" and device.index is None:
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [device]
    if grid is None:
        grid = (len(visible) // 2, 2) if len(visible) >= 2 else (4, 2)
    dp, dw = grid
    return [visible[k % len(visible)] for k in range(dp * dw)], dw


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: raises without a card) or cpu")
    ap.add_argument("--n", type=int, default=1 << 14,
                    help="points (default 2^14, the JAX demo's on hardware)")
    ap.add_argument("--grid", type=int, nargs=2, metavar=("DP", "DW"),
                    help="the sharded MSM's (points, windows) grid")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n
    rng = StdRng.seed_from_u64(0)
    rnd = random.Random(0)
    points = [rng.rand_g1() for _ in range(min(n, 4096))]
    points = (points * (-(-n // len(points))))[:n]
    scalars = [rnd.randrange(R) for _ in range(n)]

    # 1. upload the bases ONCE (the expensive part) ...
    bases = prepare_bases(points, device)
    # 2. ... then every MSM is one pipeline run + a 32 B/scalar upload
    msm_device(bases, scalars)  # kernel load + warm
    t0 = time.perf_counter()
    result = msm_device(bases, scalars)
    print(f"single-device MSM of 2^{n.bit_length()-1} on {device}: "
          f"{(time.perf_counter()-t0)*1e3:.1f} ms -> "
          f"{result.to_affine()[0]:#x}"[:100])

    # 3. the same pipeline over a points x windows grid
    devices, dw = grid_devices(device, args.grid)
    mesh = make_msm_mesh(n_window_shards=dw, devices=devices)
    sharded = sharded_msm(points, scalars, mesh)
    assert sharded == result
    print(f"sharded over grid {mesh.devices.shape} "
          f"({len(set(devices))} distinct device(s)): identical result")
    return 0


if __name__ == "__main__":
    sys.exit(main())
