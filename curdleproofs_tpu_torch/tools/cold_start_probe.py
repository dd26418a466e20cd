"""A fresh process's way to its first MSM, phase by phase (the JAX
package's `scripts/cold_start_probe.py`).

    python3 curdleproofs_tpu_torch/tools/cold_start_probe.py [logn] --out PATH
        [--first-launch]

Times, from the top of this module (before torch is imported):
  import_s              torch and the port imported
  init_s                torch.cuda.init() (with CURDLEPROOFS_BG_INIT=1,
                        starting the warm-up thread, `ops/warmup.py`)
  native_s              the native host runtime loaded (or built by g++)
  host_gen_s            4096 random bases (StdRng 7) tiled to 2^logn, and
                        2^logn random scalars (random.Random 7)
  first_device_touch_s  a first computation read back (after the warm-up
                        thread has been joined, under BG_INIT=1)
  lib_load_ms,          with --first-launch (on a card), after the first
  first_launch_ms       touch: each C entry's library found in the store
                        and bound (`kernels._lib`: verified, dlopen-ed),
                        then each C entry's first launch at a tiny width,
                        synchronized (`kernels.warm_entries`); the MSMs
                        then find every kernel loaded
  upload_s              `prepare_bases`, then an explicit synchronize
  first_msm_s           the first `msm_device` (its kernel libraries load
                        here, from the kernel store, or are built)
  second_msm_s          the next, warm
  total_cold_s          the top of the module to the first MSM's result
and reports `aot_hit` (every source's library found in the kernel store,
`ops/aot.py`), `built_s` (nvcc's seconds paid in this process: 0 on a
hit), `bg_init` (the warm-up's record, under BG_INIT=1) and `match` (both
MSMs equal to the native host MSM).  Run once on an empty store and once on
a full one, and with CURDLEPROOFS_BG_INIT=0 and =1, for the splits.
"""

import time

T_TOP = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402

POOL = 4096


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("logn", type=int, nargs="?", default=16)
    ap.add_argument("--first-launch", action="store_true",
                    help="time each kernel's first launch (on a card)")
    args = ap.parse_args(argv)
    device = common.device_of(args)
    if args.first_launch and device.type != "cuda":
        ap.error("--first-launch times kernels on a card")
    t_import = time.perf_counter()

    bg = os.environ.get("CURDLEPROOFS_BG_INIT") == "1"
    if bg:
        from curdleproofs_tpu_torch.ops.warmup import (
            start_background_init, wait_ready,
        )

        start_background_init()
    elif device.type == "cuda":
        torch.cuda.init()
    t_init = time.perf_counter()

    from curdleproofs_tpu_torch.constants import R
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops.msm_device import (
        msm_device, prepare_bases,
    )

    if not native.available():
        raise RuntimeError("the native host runtime failed to build (g++)")
    t_native = time.perf_counter()

    n = 1 << args.logn
    rng = StdRng.seed_from_u64(7)
    rnd = random.Random(7)
    base = [rng.rand_g1() for _ in range(min(POOL, n))]
    pts = [base[i % len(base)] for i in range(n)]
    ss = [rnd.randrange(R) for _ in range(n)]
    t_gen = time.perf_counter()

    bg_stats = wait_ready() if bg else None
    (torch.zeros(8, dtype=torch.int32, device=device) + 1).cpu()
    t_touch = time.perf_counter()
    lib_load, first_launch = {}, {}
    if args.first_launch:
        from curdleproofs_tpu_torch.ops import kernels

        for source, entries in kernels.ENTRIES.items():
            for entry in entries:
                t0 = time.perf_counter()
                kernels._lib(source, entry)
                lib_load[entry] = (time.perf_counter() - t0) * 1e3
        with kernels.launches_into({}):
            kernels.warm_entries(device, first_launch)
    t_touch_k = time.perf_counter()
    bases = prepare_bases(pts, device)
    common.sync(device)
    t_up = time.perf_counter()

    got = msm_device(bases, ss)
    t_first = time.perf_counter()
    got2 = msm_device(bases, ss)
    t_second = time.perf_counter()

    want = native.msm(pts, ss)
    if device.type == "cuda":
        hits = {s: aot.maybe_load(s) for s in aot.SOURCES}
        aot_hit = all(r is not None and not r["built"] for r in hits.values())
        built_s = sum(r["build_s"] for r in aot._LOADED.values()
                      if r["built"])
    else:                      # the plain versions: no kernel library
        aot_hit, built_s = None, 0.0
    art = {
        "tool": "cold_start_probe", "logn": args.logn, "aot_hit": aot_hit,
        "built_s": built_s, "store": str(aot.store_dir()),
        "cuda_module_loading": os.environ.get("CUDA_MODULE_LOADING"),
        **({"bg_init": bg_stats} if bg else {}),
        "import_s": t_import - T_TOP,
        "init_s": t_init - t_import,
        "native_s": t_native - t_init,
        "host_gen_s": t_gen - t_native,
        "first_device_touch_s": t_touch - t_gen,
        **({"lib_load_ms": lib_load, "first_launch_ms": first_launch}
           if args.first_launch else {}),
        "upload_s": t_up - t_touch_k,
        "first_msm_s": t_first - t_up,
        "second_msm_s": t_second - t_first,
        "total_cold_s": t_first - T_TOP,
        "match": got == want and got2 == want,
    }
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if art["match"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
