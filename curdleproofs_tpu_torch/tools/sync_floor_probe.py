"""Whether a single proof can profit from the card: the launch-and-readback
floor against the host's prove wall (the JAX package's
`scripts/sync_floor_probe.py`).

    python3 curdleproofs_tpu_torch/tools/sync_floor_probe.py --out PATH [--ell L]

The prover's folding rounds (log2 n in the IPA, log2 n in the same-msm
argument) each need their L/R points back on the host, hashed into the
Fiat-Shamir transcript, before the next round's challenge exists; so an
offloaded prover pays at least (serial round trips) x (launch-and-readback
floor), however fast its kernels.  Measured:
  sync_floor_ms         a one-op launch (`x + 1` on 8 int32) read back to
                        the host, median of 10 after a warm-up (spread: the
                        least and the most)
  kernel_sync_floor_ms  the same with the port's `fq_mul` kernel on [24, 1]
  host_prove_ms         the host backend's prove at l = `--ell` (default
                        252), median of 3 after a warm-up
and the implied prover floor: (2 log2 n + 3) round trips x the floor.
`match`: the read-back values are right and the last proof verifies.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys
import time

import torch

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402


def floor_ms(fn, reps: int = 10) -> tuple[float, list[float], object]:
    """Median, [least, most] and last result of `reps` timed calls of
    `fn` (after one untimed call)."""
    fn()
    ts, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), [min(ts), max(ts)], out


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("--ell", type=int, default=252)
    args = ap.parse_args(argv)
    device = common.device_of(args)

    from curdleproofs_tpu_torch.backend import HostBackend, use_backend
    from curdleproofs_tpu_torch.curdleproofs import (
        CurdleproofsProof, generate_crs,
    )
    from curdleproofs_tpu_torch.errors import VerificationError
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.field import FQ
    from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

    x = torch.zeros(8, dtype=torch.int32, device=device)
    sync_ms, spread, got = floor_ms(lambda: (x + 1).cpu())
    ok = bool((got == 1).all())
    a = FQ.const(3, (1,), device).int()
    b = FQ.const(5, (1,), device).int()
    k_ms, k_spread, got = floor_ms(lambda: K.fq_mul(a, b).cpu())
    ok = ok and torch.equal(got, FQ.const(15, (1,), "cpu").int())

    ell = args.ell
    rng = StdRng.seed_from_u64(0)
    crs = generate_crs(ell)
    perm = list(range(ell))
    rng.shuffle(perm)
    k = rng.rand_fr()
    vec_r = [rng.rand_g1() for _ in range(ell)]
    vec_s = [rng.rand_g1() for _ in range(ell)]
    with use_backend(HostBackend()):
        T, U, M, mb = shuffle_permute_and_commit_input(crs, vec_r, vec_s,
                                                       perm, k, rng)
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            proof = CurdleproofsProof.new(crs, vec_r, vec_s, T, U, M, perm, k,
                                          mb, rng)
            walls.append((time.perf_counter() - t0) * 1e3)
        try:
            proof.verify(crs, vec_r, vec_s, T, U, M, rng)
        except VerificationError as e:
            print(f"the host's proof does not verify: {e!r}", flush=True)
            ok = False
    prove_ms = statistics.median(walls[1:])

    log2n = crs.log2_n()
    syncs = 2 * log2n + 3
    art = {
        "tool": "sync_floor_probe", "ell": ell,
        "sync_floor_ms": sync_ms, "sync_floor_spread_ms": spread,
        "kernel_sync_floor_ms": k_ms, "kernel_sync_floor_spread_ms": k_spread,
        "serial_challenge_syncs": syncs,
        "prover_device_floor_ms": syncs * sync_ms,
        "host_prove_ms": prove_ms,
        "floor_over_host": syncs * sync_ms / prove_ms,
        "detail": (f"2 log2 n = {2 * log2n} folding-round challenges + 3 "
                   "commitment syncs, each one launch and read back: the "
                   "transcript on the host absorbs L/R before the next "
                   "challenge exists"),
        "match": ok,
    }
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
