"""The device MSM over sizes, with Python-int and with byte scalars, and the
per-device proxy of a points-sharded MSM (the JAX package's
`scripts/msm_sweep.py`).

    python3 curdleproofs_tpu_torch/tools/msm_sweep.py [logns...] --out PATH
        [--big N] [--proxy-logn L] [--reps R]

For each n = 2^logn (default 2^10 .. 2^20, even octaves), over POOL random
bases (StdRng 0) tiled to n and n random scalars (random.Random 1, drawn
size after size), made resident once (`prepare_ms`, synced):
  - `pick_params`'s family (c, T, s_pad);
  - `first_s`: the first MSM (with Python ints);
  - `warm_ms_ints`, `warm_ms_bytes`: the best of `--reps` MSMs with the
    scalars as Python ints and as one canonical 32-byte little-endian
    buffer (what batch verification passes), and `pack_ms`, the ints'
    packing into that buffer alone (`msm_device._scalar_bytes`);
  - `host_ms`: the native host MSM on the same inputs; `match`: every
    device result equal to it.  `result`: the device's MSM (with ints),
    compressed (hex).
`--big N` (default 626,000; 0 skips) times the same at batch
verification's deduped MSM: 4096 bases tiled to N and the scalars of
`kernel_probe.fold_data`, as `chip_smoke.py`'s phase 3 draws them.
`--proxy-logn L` (default 16; 0 skips): the per-device work of a D-way
points-sharded MSM is the same pipeline at n/D points (window sums add
across shards), timed warm for D = 1, 2, 4, 8 at n = 2^L.
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

POOL = 4096


def make_pool(size: int) -> list:
    """The sweep's bases: `size` random points from StdRng 0."""
    from curdleproofs_tpu_torch.host.rng import StdRng

    rng = StdRng.seed_from_u64(0)
    return [rng.rand_g1() for _ in range(size)]


def sample(pool: list, n: int, rnd: random.Random) -> tuple[list, list]:
    """n points (the pool tiled) and n scalars drawn from `rnd`."""
    from curdleproofs_tpu_torch.constants import R

    return ([pool[i % len(pool)] for i in range(n)],
            [rnd.randrange(R) for _ in range(n)])


def best_ms(fn, reps: int, device) -> tuple[float, object]:
    """Best wall of `reps` synced calls of `fn`, and the last result."""
    best, out = float("inf"), None
    for _ in range(reps):
        common.sync(device)
        t0 = time.perf_counter()
        out = fn()
        common.sync(device)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def measure(pts, ss, device, reps: int, host_reps: int) -> dict:
    """One size: residency, first and warm walls (ints, bytes), the host's
    wall, and whether every result equals the host's."""
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.serde import g1_to_bytes
    from curdleproofs_tpu_torch.ops import msm_device as md

    n = len(pts)
    params = md.pick_params(n, device=device)
    common.sync(device)
    t0 = time.perf_counter()
    bases = md.DeviceBases(pts, device)
    common.sync(device)
    prepare_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r_first = md.msm_device(bases, ss)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sbytes = md._scalar_bytes(ss)
    pack_ms = (time.perf_counter() - t0) * 1e3
    ints_ms, r_ints = best_ms(lambda: md.msm_device(bases, ss), reps, device)
    bytes_ms, r_bytes = best_ms(lambda: md.msm_device(bases, sbytes), reps,
                                device)
    host_ms = float("inf")
    for _ in range(host_reps):
        t0 = time.perf_counter()
        want = native.msm(pts, ss)
        host_ms = min(host_ms, (time.perf_counter() - t0) * 1e3)
    return {
        "n": n, "c": params.c, "t_rows": params.t_rows, "s_pad": params.s_pad,
        "prepare_ms": prepare_ms, "first_s": first_s, "pack_ms": pack_ms,
        "warm_ms_ints": ints_ms, "warm_ms_bytes": bytes_ms,
        "muls_per_s": n / (min(ints_ms, bytes_ms) / 1e3),
        "host_ms": host_ms, "speedup_vs_host": host_ms / ints_ms,
        "result": g1_to_bytes(r_ints).hex(),
        "match": r_first == want and r_ints == want and r_bytes == want,
    }


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("logns", type=int, nargs="*",
                    default=[10, 12, 14, 16, 18, 20])
    ap.add_argument("--big", type=int, default=626_000)
    ap.add_argument("--proxy-logn", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = common.device_of(args)

    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import msm_device as md
    from curdleproofs_tpu_torch.tools.kernel_probe import FOLD_SEED, fold_data

    if not native.available():
        raise RuntimeError("the sweep checks against the native host MSM, "
                           "which failed to build")
    sizes = [1 << e for e in args.logns]
    if args.proxy_logn:
        sizes.append(1 << args.proxy_logn)
    pool = make_pool(min(POOL, max(sizes)))
    rnd = random.Random(1)
    rows = []
    for logn in args.logns:
        pts, ss = sample(pool, 1 << logn, rnd)
        row = {"log_n": logn, **measure(pts, ss, device, args.reps,
                                        2 if logn <= 16 else 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    big = None
    if args.big:
        _, pts, ss = fold_data(StdRng.seed_from_u64(FOLD_SEED),
                               random.Random(FOLD_SEED))
        big = measure(pts[:args.big], ss[:args.big], device, args.reps, 1)
        print(json.dumps({"big": big}), flush=True)

    proxy = None
    if args.proxy_logn:
        n = 1 << args.proxy_logn
        pts, ss = sample(pool, n, rnd)
        proxy = {"n": n, "per_device_ms_at_n_over_D": {}}
        ok = True
        for d in (1, 2, 4, 8):
            sub_p, sub_s = pts[:n // d], ss[:n // d]
            bases = md.DeviceBases(sub_p, device)
            got = md.msm_device(bases, sub_s)        # loads and warms
            ms, _ = best_ms(lambda: md.msm_device(bases, sub_s), args.reps,
                            device)
            ok = ok and got == native.msm(sub_p, sub_s)
            proxy["per_device_ms_at_n_over_D"][str(d)] = ms
        proxy["match"] = ok
        print(json.dumps({"shard_proxy": proxy}), flush=True)

    match = all(r["match"] for r in rows) and (big is None or big["match"]) \
        and (proxy is None or proxy["match"])
    art = {"tool": "msm_sweep", "pool": len(pool), "reps": args.reps,
           "rows": rows, "big": big, "shard_proxy": proxy, "match": match}
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if match else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
