"""B lockstep proofs on the card against B sequential host proves (the JAX
package's `scripts/batch_prove_bench.py`).

    python3 curdleproofs_tpu_torch/tools/batch_prove_bench.py [B] [ell]
        --out PATH [--no-warm]

`batch_prove` runs every folding round of the whole batch as one grouped
MSM dispatch on `TorchBackend(device)` (about 20 dispatches whatever B).
The instances share one (R, S) tracker set (StdRng 42, the Whisk relay's
shape) and draw their permutation, randomiser and blinders from their own
StdRng (1000 + i).  Timed: `host_ms_per_proof`, the sequential host prover
over min(8, B) instances; `cold_s`, the first batch (kernel loads, first
uploads); `warm_s`, a second batch on fresh instances (skipped with
`--no-warm`), with `batch_prove.last_timings`.  `match`: every host proof's
bytes equal the batch's, and the batch's last proof verifies.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402


def make_instances(crs, ell: int, count: int) -> list:
    """The bench's instances, made on the host backend."""
    from curdleproofs_tpu_torch.backend import HostBackend, use_backend
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.parallel.batch_prove import ProveInstance
    from curdleproofs_tpu_torch.util import get_permutation, msm

    base_rng = StdRng.seed_from_u64(42)
    vec_r = [base_rng.rand_g1() for _ in range(ell)]
    vec_s = [base_rng.rand_g1() for _ in range(ell)]
    out = []
    with use_backend(HostBackend()) as hb:
        for i in range(count):
            rng = StdRng.seed_from_u64(1000 + i)
            perm = list(range(ell))
            rng.shuffle(perm)
            k = rng.rand_fr()
            vec_t = get_permutation(hb.batch_mul(vec_r, k), perm)
            vec_u = get_permutation(hb.batch_mul(vec_s, k), perm)
            blinders = [rng.rand_fr() for _ in range(4)]
            m = msm(list(crs.vec_G) + list(crs.vec_H), list(perm) + blinders)
            out.append(ProveInstance(vec_r, vec_s, vec_t, vec_u, m, perm, k,
                                     blinders, rng))
    return out


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("shape", type=int, nargs="*", default=[128, 252],
                    help="B ell")
    ap.add_argument("--no-warm", action="store_true",
                    help="time only the first batch")
    args = ap.parse_args(argv)
    if len(args.shape) != 2:
        ap.error("give B and ell together")
    b, ell = args.shape
    device = common.device_of(args)

    from curdleproofs_tpu_torch.backend import HostBackend, use_backend
    from curdleproofs_tpu_torch.curdleproofs import (
        CurdleproofsProof, generate_crs,
    )
    from curdleproofs_tpu_torch.errors import VerificationError
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops.backend import TorchBackend
    from curdleproofs_tpu_torch.parallel.batch_prove import batch_prove

    t0 = time.perf_counter()
    crs = generate_crs(ell)
    insts = make_instances(crs, ell, b)
    gen_s = time.perf_counter() - t0

    n_host = min(8, b)
    with use_backend(HostBackend()):
        t0 = time.perf_counter()
        host = [CurdleproofsProof.new(
            crs, i.vec_R, i.vec_S, i.vec_T, i.vec_U, i.M, i.permutation, i.k,
            i.vec_m_blinders, i.rng).serialize() for i in insts[:n_host]]
        host_ms = (time.perf_counter() - t0) / n_host * 1e3

    runs = {}
    with use_backend(TorchBackend(device)):
        for label in ("cold", "warm")[: 1 if args.no_warm else 2]:
            batch = make_instances(crs, ell, b)
            common.sync(device)
            t0 = time.perf_counter()
            proofs = batch_prove(crs, batch)
            common.sync(device)
            runs[label] = (time.perf_counter() - t0,
                           dict(batch_prove.last_timings), batch, proofs)
    wall, timings, batch, proofs = runs["warm" if "warm" in runs else "cold"]
    bytes_ok = [p.serialize() for p in proofs[:n_host]] == host
    last = batch[-1]
    try:
        with use_backend(HostBackend()):
            proofs[-1].verify(crs, last.vec_R, last.vec_S, last.vec_T,
                              last.vec_U, last.M, StdRng.seed_from_u64(7))
        verify_ok = True
    except VerificationError:
        verify_ok = False
    art = {
        "tool": "batch_prove_bench", "B": b, "ell": ell, "device_backend":
            f"TorchBackend({device})",
        "host_ms_per_proof": host_ms, "host_proofs": n_host,
        "host_batch_s": host_ms * b / 1e3,
        "cold_s": runs["cold"][0],
        "warm_s": runs["warm"][0] if "warm" in runs else None,
        "proofs_per_s": b / wall, "proofs_per_s_host": 1e3 / host_ms,
        "speedup_vs_host": host_ms * b / 1e3 / wall,
        "gen_s": gen_s, "phases": timings,
        "gates": {"bytes_match_sequential": bytes_ok,
                  "verify_ok": verify_ok},
        "match": bytes_ok and verify_ok,
    }
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if art["match"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
