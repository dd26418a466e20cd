"""Measure device-MSM parameters per shape family and persist the winners
(the JAX package's `scripts/msm_autotune.py`, on the card).

    python3 curdleproofs_tpu_torch/tools/msm_autotune.py [logns...]

The port ships the table this tool made on an H100
(`curdleproofs_tpu_torch/ops/msm_tune.json`): two passes over 7 8 9 10 12
14 16 18 20 from a clean tree, the second agreeing with the first (no
entry quarantined).  Remake it the same way on the card it is for; point
`CURDLEPROOFS_TUNE` elsewhere to measure without touching it.

For each family n = 2^logn (default 2^10..2^20, even octaves):
  - the device warm wall of `msm_device` per candidate window width (c = 8
    always; c = 16 from 2^16 up, below which its 32k-bucket slot floor
    dominates), the best of three runs after one that builds and warms;
  - `fresh_prep_ms`: a non-resident MSM's base preparation (native
    Montgomery export, upload, sqrt ingest), synced, after a synced warm-up
    construction; `fresh_prep_host_ms`: its host-blocking share (the
    construction's return, before the sync); `ingest_dev_ms`: the device's
    upload and ingest per chunk in a steady feed (four back-to-back
    constructions, one sync: (T4 - host share) / 4);
  - `host_ms`: the native host Pippenger wall on the same inputs (best of
    two).
Every device result must equal the host's.  Each family's entry goes
through `msm_tune.record_entry` under the device's type (`"cuda"`) into
`msm_tune.table_path()`: `CURDLEPROOFS_TUNE` names the file, and
`CURDLEPROOFS_TUNE_FORCE=1` bypasses the contention guard.  After the
pass, `main` writes the table's `"stamp"` (`msm_tune.record_stamp`): the
card's nvidia-smi line, the commit (`$CURDLEPROOFS_COMMIT` in a copy
without `.git`), the sources' sha256, torch's version, the UTC date, the
families of the pass and any it quarantined.  `pick_params`,
`HybridBackend` and batch verification's split then read it.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


POOL_SIZE = 4096  # random points, tiled to each family's n
REPS = 3          # timed warm runs per candidate c, best kept


def tune(logns, device="cuda", log=print) -> dict[int, tuple[dict, str]]:
    """Measure each family 2^logn on `device` and record it; returns
    {n_pad: (entry, "written" | "quarantined")}."""
    import random

    from curdleproofs_tpu_torch.constants import R
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops.device import resolve_device
    from curdleproofs_tpu_torch.ops.msm_device import (
        DeviceBases, msm_device, pick_params,
    )
    from curdleproofs_tpu_torch.ops.msm_tune import record_entry

    device = resolve_device(device)
    if not native.available():
        raise RuntimeError("the autotuner compares with the native host MSM, "
                           "which failed to build")
    rng = StdRng.seed_from_u64(11)
    rnd = random.Random(11)
    pool = [rng.rand_g1() for _ in range(POOL_SIZE)]
    force = os.environ.get("CURDLEPROOFS_TUNE_FORCE") == "1"
    out = {}
    for logn in logns:
        n = 1 << logn
        pts = [pool[i % len(pool)] for i in range(n)]
        ss = [rnd.randrange(R) for _ in range(n)]

        t0 = time.perf_counter()
        want = native.msm(pts, ss)
        t1 = time.perf_counter()
        native.msm(pts, ss)
        host_ms = min(t1 - t0, time.perf_counter() - t1) * 1e3

        # fresh-base prep, synced, after a synced warm-up construction (the
        # first pays the process's first uploads and kernel loads)
        DeviceBases(pts, device)
        _sync(device)
        t0 = time.perf_counter()
        bases = DeviceBases(pts, device)
        t_host = time.perf_counter()
        _sync(device)
        fresh_prep_ms = (time.perf_counter() - t0) * 1e3
        fresh_prep_host_ms = (t_host - t0) * 1e3

        # steady-state feed: four back-to-back fresh uploads, one sync
        t0 = time.perf_counter()
        feed = [DeviceBases(pts, device) for _ in range(4)]
        _sync(device)
        t4_ms = (time.perf_counter() - t0) * 1e3
        ingest_dev_ms = max(0.0, t4_ms - fresh_prep_host_ms) / 4
        del feed

        results = {}
        for c in ([8] if n < (1 << 16) else [8, 16]):
            params = pick_params(n, c, device)
            t0 = time.perf_counter()
            got = msm_device(bases, ss, c=c)
            first_s = time.perf_counter() - t0
            if got != want:
                raise AssertionError(f"2^{logn} c={c}: the device MSM "
                                     f"differs from the host's")
            best = float("inf")
            for _ in range(REPS):
                t0 = time.perf_counter()
                msm_device(bases, ss, c=c)
                best = min(best, time.perf_counter() - t0)
            results[c] = (best * 1e3, params)
            log(f"2^{logn} c={c}: warm {best * 1e3:.3f} ms (first "
                f"{first_s:.3f} s, t={params.t_rows}, s_pad={params.s_pad}); "
                f"equal to the host's")

        c_win = min(results, key=lambda c: results[c][0])
        warm_ms, params = results[c_win]
        entry = {
            "c": c_win,
            "t_rows": params.t_rows,
            "s_pad": params.s_pad,
            "device_warm_ms": warm_ms,
            "fresh_prep_ms": fresh_prep_ms,
            "fresh_prep_host_ms": fresh_prep_host_ms,
            "ingest_dev_ms": ingest_dev_ms,
            "host_ms": host_ms,
            "losers": {str(c): results[c][0] for c in results if c != c_win},
        }
        status = record_entry(params.n, entry, force=force, device=device)
        log(f"2^{logn} -> n_pad={params.n} [{status}]: {json.dumps(entry)}")
        out[params.n] = (entry, status)
    return out


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import datetime

    import torch

    from curdleproofs_tpu_torch.ops.msm_tune import record_stamp, table_path
    from curdleproofs_tpu_torch.tools.common import card_line, stamps

    logns = [int(a) for a in argv] or [10, 12, 14, 16, 18, 20]
    print(card_line(), flush=True)  # raises without a card, as tune() does
    out = tune(logns, log=lambda *a: print(*a, flush=True))
    stamp = stamps(torch.device("cuda"))
    del stamp["device"]
    stamp.update(
        date=datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
        logns=logns,
        quarantined=sorted(n for n, (_, st) in out.items()
                           if st == "quarantined"))
    record_stamp(stamp)
    print(f"table written: {table_path()}; stamp {json.dumps(stamp)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
