"""Stage profile of the grouped MSM, the batched prover's round dispatch
(the JAX package's `scripts/grouped_profile.py`).

    python3 curdleproofs_tpu_torch/tools/grouped_profile.py [n_rel width]
        --out PATH [--bases N] [--reps R]

One dispatch of `n_rel` relations (default 1536) of `width` columns
(default 128) over N resident bases (default 258,560, the batched
prover's at B = 256, l = 252: a pool of 512 random points, StdRng 3,
tiled), random columns and scalars (numpy, seed 7), in both of the port's
modes:
  slot   (`grouped_slot_run`): upload, recode, plan, fold, merge, suffix,
         and Horner apart (`horner_device`: 64 x (4 doublings + 1 add)
         and leave-Montgomery, a group of lanes a relation of one
         `g1_horner` launch);
  table  (`grouped_table_run`, over `DeviceBasesTable`, whose build is
         timed once): upload, recode, plan, fold, Horner.
Each stage's device ms (CUDA events after an explicit synchronize; the
host clock on the CPU), the median over `--reps` runs (default 3) after an
untimed one, with the host's packing (`pack_ms`) and decoding
(`decode_ms`); `match`: every relation's point equals the native host
MSM of its columns.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys
import time

import numpy as np

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402


def run_mode(mode: str, resident, relations, device, reps: int) -> dict:
    """Profile one mode over `resident` (DeviceBases, or DeviceBasesTable
    for table mode); returns stages, host shares and the points."""
    from curdleproofs_tpu_torch.ops import msm_grouped as mg
    from curdleproofs_tpu_torch.ops.msm_device import use_madd

    madd = use_madd()
    width = max(len(c) for c, _ in relations)
    if mode == "slot":
        params = mg.pick_grouped_params(len(relations), width, resident.n)
        n_rel = params.n_rel
    else:
        n_rel = mg._round_up(max(len(relations), 8), 8)
    runs, packs, decodes, out = [], [], [], None
    for rep in range(reps + 1):                  # the first run is untimed
        clock = common.Clock(device)
        common.sync(device)
        t0 = time.perf_counter()
        packed = mg.pack_relations(relations, n_rel, width, resident.n)
        packs.append((time.perf_counter() - t0) * 1e3)
        clock.mark("start")
        lt, ct = mg.upload_relations(*packed, device)
        clock.mark("upload")
        if mode == "slot":
            res = mg.grouped_slot_run(
                resident.ext_px, resident.ext_py, resident.ext_zb, lt, ct,
                params=params, madd=madd, mark=clock.mark)
        else:
            res = mg.grouped_table_run(
                resident.ext_px, resident.ext_py, resident.ext_zb, lt, ct,
                n_rel=n_rel, width=width, n_base=resident.n, madd=madd,
                mark=clock.mark)
        stages = clock.stages()
        t0 = time.perf_counter()
        out = mg.decode_points(res.cpu().numpy())[: len(relations)]
        decodes.append((time.perf_counter() - t0) * 1e3)
        if rep:
            runs.append(stages)
    stage_ms = {s: statistics.median(r[s] for r in runs) for s in runs[0]}
    return {"n_rel": n_rel, "width": width, "madd": madd,
            "stage_ms": stage_ms, "device_ms": sum(stage_ms.values()),
            "pack_ms": statistics.median(packs[1:]),
            "decode_ms": statistics.median(decodes[1:]), "points": out}


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("shape", type=int, nargs="*", default=[1536, 128],
                    help="n_rel width")
    ap.add_argument("--bases", type=int, default=256 * 4 * 252 + 512)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if len(args.shape) != 2:
        ap.error("give n_rel and width together")
    n_rel, width = args.shape
    device = common.device_of(args)

    from curdleproofs_tpu_torch.constants import R
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import msm_grouped as mg
    from curdleproofs_tpu_torch.ops.msm_device import DeviceBases

    rng = StdRng.seed_from_u64(3)
    pool = [rng.rand_g1() for _ in range(min(512, args.bases))]
    pts = [pool[i % len(pool)] for i in range(args.bases)]
    common.sync(device)
    t0 = time.perf_counter()
    bases = DeviceBases(pts, device)
    common.sync(device)
    bases_ms = (time.perf_counter() - t0) * 1e3
    rnd = np.random.default_rng(7)
    cols = rnd.integers(0, args.bases, (n_rel, width))
    relations = [(list(map(int, c)),
                  [int.from_bytes(rnd.bytes(32), "little") % R
                   for _ in range(width)]) for c in cols]
    want = [native.msm([pts[i] for i in c], s) for c, s in relations]

    modes = {"slot": run_mode("slot", bases, relations, device, args.reps)}
    common.sync(device)
    t0 = time.perf_counter()
    table = mg.DeviceBasesTable(bases)
    common.sync(device)
    table_ms = (time.perf_counter() - t0) * 1e3
    modes["table"] = run_mode("table", table, relations, device, args.reps)
    for m in modes.values():
        m["match"] = m.pop("points") == want
        print(json.dumps(m), flush=True)
    art = {"tool": "grouped_profile", "n_rel": n_rel, "width": width,
           "bases": args.bases, "bases_ms": bases_ms, "table_ms": table_ms,
           "modes": modes,
           "match": all(m["match"] for m in modes.values())}
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if art["match"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
