"""Stage profile of the device MSM pipeline (the JAX package's
`scripts/msm_profile.py`).

    python3 curdleproofs_tpu_torch/tools/msm_profile.py [logns...] --out PATH
        [--reps R]

The reference times cumulative prefixes of its pipeline and takes their
differences, because XLA fuses the stages of one program.  The port's
stages run eagerly, so each is timed directly: `msm_device(..., mark=)`
records a CUDA event as each stage has been queued (on the CPU, the host
clock), after an explicit synchronize, over resident bases (4096 random
points, StdRng 0, tiled to n = 2^logn; default 16, 18, 20) and random
scalars (random.Random 1).  One untimed run first; then, per stage, the
median over `--reps` runs (default 3) of its ms:

    upload      the scalars packed into limbs on the host and uploaded
    recode      signed-digit recode
    plan        per-window bucket sort and slot plan
    fold        the bucket fold kernel (it gathers the bases itself)
    merge       slot merge (g1_add scan steps)
    dense       dense bucket layout
    suffix      the suffix kernel of the bucket reduction
    reduce      the rest of the reduction (chunk scans, doublings)
    leave_mont  leave Montgomery (one fq_mul)

and the wall (host clock, the window sums' download and the host's Horner
included), `pack_ms` (the host's share of upload), and `match` against the
native host MSM.  `STAGE_MAP` maps each stage to the reference's phases.
"""

from __future__ import annotations

import json
import pathlib
import random
import statistics
import sys
import time

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402

# the port's stages -> the reference's phases (digits, sort, plan, gather,
# fold, merge; "full" is its residual: the bucket reduction and leaving
# Montgomery).  `upload` lies outside the reference's profiled program,
# whose limbs were already on the device.
STAGE_MAP = {
    "upload": [],
    "recode": ["digits"],
    "plan": ["sort", "plan"],
    "fold": ["gather", "fold"],
    "merge": ["merge"],
    "dense": ["full"],
    "suffix": ["full"],
    "reduce": ["full"],
    "leave_mont": ["full"],
}


def profile(n: int, pool: list, rnd: random.Random, device, reps: int
            ) -> dict:
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.ops import msm_device as md
    from curdleproofs_tpu_torch.tools.msm_sweep import sample

    pts, ss = sample(pool, n, rnd)
    params = md.pick_params(n, device=device)
    bases = md.DeviceBases(pts, device)
    want = native.msm(pts, ss)
    ok = md.msm_device(bases, ss) == want          # untimed: loads and warms
    runs, walls = [], []
    for _ in range(reps):
        clock = common.Clock(device)
        common.sync(device)
        t0 = time.perf_counter()
        clock.mark("start")
        got = md.msm_device(bases, ss, mark=clock.mark)
        walls.append((time.perf_counter() - t0) * 1e3)
        runs.append(clock.stages())
        ok = ok and got == want
    t0 = time.perf_counter()
    md._scalars_to_limbs(ss, params.n)
    pack_ms = (time.perf_counter() - t0) * 1e3
    stages = {s: statistics.median(r[s] for r in runs) for s in runs[0]}
    return {"n": n, "c": params.c, "t_rows": params.t_rows,
            "s_pad": params.s_pad, "stage_ms": stages,
            "stage_ms_runs": runs, "stages_total_ms": sum(stages.values()),
            "wall_ms": statistics.median(walls), "pack_ms": pack_ms,
            "match": ok}


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("logns", type=int, nargs="*", default=[16, 18, 20])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = common.device_of(args)
    from curdleproofs_tpu_torch.tools.msm_sweep import POOL, make_pool

    pool = make_pool(min(POOL, 1 << max(args.logns)))
    rnd = random.Random(1)
    results = {}
    for logn in args.logns:
        results[str(logn)] = profile(1 << logn, pool, rnd, device, args.reps)
        print(json.dumps({logn: results[str(logn)]["stage_ms"]}), flush=True)
    art = {"tool": "msm_profile", "clock": ("cuda events" if device.type ==
                                             "cuda" else "host"),
           "stage_map": STAGE_MAP, "results": results,
           "match": all(r["match"] for r in results.values())}
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if art["match"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
