"""Batch verification split across two processes: what each half costs
alone, and a live two-rank run (the JAX package's
`scripts/multihost_scaling.py`).

    python3 curdleproofs_tpu_torch/tools/multihost_scaling.py [B ell]
        --out PATH [--rounds K]

B proofs at l = ell (default 1024 and 252, the reference's batched
verification configuration), deterministic: a shared (R, S) set (StdRng 3)
and per-proof StdRng (10,000 + i), proved once on the host by the parent.
Each verification replays its proofs into one accumulator and runs the
deduped MSM (`msm_raw`) on `TorchBackend(--device)`, which sends it to the
card from 8 points (32-byte scalars where the native dedup made them,
as batch verification does).  Measured:
  - in the parent, interleaved (`--rounds`, default 5, of single, h0, h1,
    so the three share the host's weather), the whole batch and each half
    alone:
    replay and MSM seconds, each the least over the rounds;
  - a live world of two gloo ranks (on one card both share it), each
    verifying its `process_slice` and AND-reducing the verdict twice
    (`all_hosts_agree`; the first gather sets the group up).
`efficiency_isolated` = T_single / (2 x max(T_h0, T_h1)): what two
machines, each with its own card, would reach when the verdict's gather
is all they share; `efficiency_concurrent` = T_single / the live wall, on
this machine.  `match`: every verdict is True.  The proofs pass to the
ranks through a temporary file, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402

WORLD = 2
TIMEOUT_S = 1800.0                    # the parent's wait for both ranks


def instances(b: int, ell: int):
    """(crs, [ShuffleInstance], [(perm, k, blinders, rng)]): the batch."""
    from curdleproofs_tpu_torch.backend import HostBackend, use_backend
    from curdleproofs_tpu_torch.curdleproofs import generate_crs
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.parallel.batch_verify import ShuffleInstance
    from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

    crs = generate_crs(ell)
    base = StdRng.seed_from_u64(3)
    vec_r = [base.rand_g1() for _ in range(ell)]
    vec_s = [base.rand_g1() for _ in range(ell)]
    insts, wits = [], []
    with use_backend(HostBackend()):
        for i in range(b):
            rng = StdRng.seed_from_u64(10_000 + i)
            perm = list(range(ell))
            rng.shuffle(perm)
            k = rng.rand_fr()
            t, u, m, mb = shuffle_permute_and_commit_input(crs, vec_r, vec_s,
                                                           perm, k, rng)
            insts.append(ShuffleInstance(vec_r, vec_s, t, u, m))
            wits.append((perm, k, mb, rng))
    return crs, insts, wits


def timed_verify(crs, insts, proofs, seed: int, device) -> dict:
    """Replay `proofs` into one accumulator, then its deduped MSM on
    `TorchBackend(device)`: the verdict and each part's seconds."""
    from curdleproofs_tpu_torch.backend import use_backend
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.msm_accumulator import MsmAccumulator
    from curdleproofs_tpu_torch.ops.backend import TorchBackend

    rng = StdRng.seed_from_u64(seed)
    acc = MsmAccumulator()
    with use_backend(TorchBackend(device)) as be:
        t0 = time.perf_counter()
        for inst, pf in zip(insts, proofs):
            pf.verify_with_accumulator(crs, inst.vec_R, inst.vec_S,
                                       inst.vec_T, inst.vec_U, inst.M, acc,
                                       rng)
        replay = time.perf_counter() - t0
        bases, scalars = acc.dedup_raw()
        t0 = time.perf_counter()
        msm = be.msm_raw if isinstance(scalars, (bytes, bytearray)) \
            else be.msm       # the accumulator's ints below its native sweep
        ok = msm(bases, scalars).is_infinity()
        common.sync(device)
        msm = time.perf_counter() - t0
    return {"ok": bool(ok), "n": len(proofs), "replay_s": replay,
            "msm_s": msm, "msm_bases": len(bases), "wall_s": replay + msm}


def load_proofs(path: pathlib.Path, b: int, log2n: int) -> list:
    from curdleproofs_tpu_torch.curdleproofs import CurdleproofsProof
    from curdleproofs_tpu_torch.host.serde import deferred_subgroup_checks

    raw = path.read_bytes()
    each = len(raw) // b
    with deferred_subgroup_checks():
        return [CurdleproofsProof.deserialize(raw[i * each:(i + 1) * each],
                                              log2n) for i in range(b)]


def worker(rank: int, coordinator: str, proofs_path: pathlib.Path, b: int,
           ell: int, device) -> None:
    import torch.distributed as dist

    from curdleproofs_tpu_torch.parallel.distributed import (
        all_hosts_agree, init_multihost, process_slice,
    )

    pid, world = init_multihost(coordinator, WORLD, rank)
    try:
        crs, insts, _ = instances(b, ell)
        proofs = load_proofs(proofs_path, b, crs.log2_n())
        sl = process_slice(b)
        t0 = time.perf_counter()
        out = timed_verify(crs, insts[sl], proofs[sl], 99, device)
        t1 = time.perf_counter()
        agreed = all_hosts_agree(out["ok"])
        t2 = time.perf_counter()
        agreed2 = all_hosts_agree(out["ok"])
        out.update(rank=pid, world=world, slice=[sl.start, sl.stop],
                   allgather_first_ms=(t2 - t1) * 1e3,
                   allgather_warm_ms=(time.perf_counter() - t2) * 1e3,
                   wall_with_collective_s=t2 - t0,
                   global_ok=bool(agreed and agreed2))
        print("WORKER " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def parent(args, device) -> int:
    from curdleproofs_tpu_torch.backend import HostBackend, use_backend
    from curdleproofs_tpu_torch.curdleproofs import CurdleproofsProof
    from curdleproofs_tpu_torch.tools.multihost_verify import _free_port

    t_start = time.perf_counter()
    b, ell = args.shape
    crs, insts, wits = instances(b, ell)
    with use_backend(HostBackend()):
        proofs = [CurdleproofsProof.new(crs, i.vec_R, i.vec_S, i.vec_T,
                                        i.vec_U, i.M, perm, k, mb, rng)
                  for i, (perm, k, mb, rng) in zip(insts, wits)]
    prove_s = time.perf_counter() - t_start

    half = b // 2
    slices = {"single": (0, b), "h0": (0, half), "h1": (half, b)}
    runs = {k: [] for k in slices}
    for rep in range(args.rounds):
        for k, (lo, hi) in slices.items():
            runs[k].append(timed_verify(crs, insts[lo:hi], proofs[lo:hi],
                                        99 + rep, device))
    walls = {}
    for k, outs in runs.items():
        replay = min(o["replay_s"] for o in outs)
        msm = min(o["msm_s"] for o in outs)
        walls[k] = {"ok": all(o["ok"] for o in outs), "n": outs[0]["n"],
                    "replay_s": replay, "msm_s": msm,
                    "msm_bases": outs[0]["msm_bases"],
                    "wall_s": replay + msm,
                    "wall_spread_s": [min(o["wall_s"] for o in outs),
                                      max(o["wall_s"] for o in outs)]}
    print(json.dumps(walls), flush=True)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(common.REPO), env.get("PYTHONPATH")) if p)
    coordinator = f"localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        proofs_path = pathlib.Path(tmp) / "proofs.bin"
        proofs_path.write_bytes(b"".join(p.serialize() for p in proofs))
        logs = [pathlib.Path(tmp) / f"rank{r}.log" for r in range(WORLD)]
        t0 = time.perf_counter()
        procs = []
        try:
            for r in range(WORLD):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, __file__, str(b), str(ell),
                         "--device", str(device), "--out", str(args.out),
                         "--rank", str(r), "--coordinator", coordinator,
                         "--proofs", str(proofs_path)],
                        stdout=log, stderr=subprocess.STDOUT, env=env,
                        cwd=str(common.REPO)))
            for p in procs:
                p.wait(timeout=max(1.0, t0 + TIMEOUT_S - time.perf_counter()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
        live_wall = time.perf_counter() - t0
        texts = [f.read_text() for f in logs]
    workers = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        lines = [ln for ln in text.splitlines() if ln.startswith("WORKER ")]
        if p.returncode or not lines:
            print(f"rank {r} exited {p.returncode} with no result:\n{text}")
            return 1
        workers.append(json.loads(lines[-1][len("WORKER "):]))

    single, h0, h1 = walls["single"], walls["h0"], walls["h1"]
    t_iso = max(h0["wall_s"], h1["wall_s"])
    ok = (single["ok"] and h0["ok"] and h1["ok"]
          and all(w["global_ok"] and w["world"] == WORLD for w in workers))
    art = {
        "tool": "multihost_scaling", "world": WORLD, "batch": b, "ell": ell,
        "prove_s": prove_s, "single_host": single,
        "per_host_isolated": [h0, h1],
        "efficiency_isolated": single["wall_s"] / (WORLD * t_iso),
        "live_world2": {"workers": workers, "wall_s": live_wall,
                        "efficiency_concurrent": single["wall_s"] / live_wall},
        "proofs_per_s_single": b / single["wall_s"],
        "proofs_per_s_scaled": b / t_iso,
        "total_s": time.perf_counter() - t_start, "match": ok,
    }
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("shape", type=int, nargs="*", default=[1024, 252],
                    help="B ell")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--proofs", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if len(args.shape) != 2:
        ap.error("give B and ell together")
    device = common.device_of(args)
    if args.rank is not None:
        worker(args.rank, args.coordinator, args.proofs, *args.shape, device)
        return 0
    return parent(args, device)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
