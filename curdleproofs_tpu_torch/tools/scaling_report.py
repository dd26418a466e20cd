"""The sharded MSM on grids of D = 1, 2, 4, 8 cells (the JAX package's
`scripts/scaling_report.py`).

    python3 curdleproofs_tpu_torch/tools/scaling_report.py --out PATH
        [--n N] [--ds D ...]

The reference validates its sharding program on a virtual 8-device CPU
mesh.  The port's counterpart is a logical grid (`sharded_msm.MsmMesh`)
whose every cell is `--device`, one process driving the cells one after
another: it validates the points partitioning, the points-axis
reduce and the host combine, and its walls show what sharding costs on one
device, never how it scales.  The work model is the reference's: a cell's
share of the N points (ceil(N / D)) times its windows.  For each D (a
(D, 1) grid, as the reference's points-sharded mesh), the sharded MSM of
N (default 256) random points (StdRng 2) and scalars (random.Random 2)
and its wall; `match`: every result equals the native host MSM.
"""

from __future__ import annotations

import json
import pathlib
import random
import sys
import time

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--ds", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    device = common.device_of(args)

    from curdleproofs_tpu_torch.constants import R
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.parallel.sharded_msm import (
        _pick_c, make_msm_mesh, sharded_msm,
    )

    rng = StdRng.seed_from_u64(2)
    rnd = random.Random(2)
    n = args.n
    pts = [rng.rand_g1() for _ in range(n)]
    ss = [rnd.randrange(R) for _ in range(n)]
    want = native.msm(pts, ss)
    windows = -(-255 // _pick_c(n))
    rows = []
    for d in args.ds:
        mesh = make_msm_mesh(d, devices=[device] * d)
        dp, dw = mesh.devices.shape
        common.sync(device)
        t0 = time.perf_counter()
        got = sharded_msm(pts, ss, mesh)
        common.sync(device)
        wall = time.perf_counter() - t0
        rows.append({"devices": d, "grid": [dp, dw], "match": got == want,
                     "cell_points": -(-n // dp),
                     "cell_windows": -(-windows // dw),
                     "cell_work": -(-n // dp) * -(-windows // dw),
                     "wall_s": wall})
        print(json.dumps(rows[-1]), flush=True)
    art = {"tool": "scaling_report", "n": n, "windows": windows,
           "grid": "logical: every cell is " + str(device), "rows": rows,
           "match": all(r["match"] for r in rows)}
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if art["match"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
