"""Two-process distributed batch verification over a real process group
(the JAX package's `scripts/multihost_verify.py`, on `torch.distributed`).

    python3 curdleproofs_tpu_torch/tools/multihost_verify.py --out PATH

The parent spawns two worker processes on this machine.  Each joins a gloo
process group through `init_multihost` (a coordinator on localhost, at a
port the parent found free), builds the same batch, and verifies its
`process_slice` of it with `distributed_batch_verify`; the verdicts
AND-reduce with `all_hosts_agree`, the one collective this placement needs
(see `parallel/distributed.py`).  Each process runs its MSMs on the backend
`CURDLEPROOFS_BACKEND` names: `host` on a CPU machine, `torch` (the
default) on a card, where both processes share `cuda:0`.

Two passes exercise the reduction both ways:
  pass "valid":   every proof good  -> local True/True   -> global True
  pass "corrupt": a proof in rank 1's slice is bad (T/U swapped)
                  -> local True(rank0)/False(rank1)      -> global False on BOTH

The parent writes the artifact to `--out` (through `write_artifact`, which
refuses a smaller run over a larger one) and prints it as its last line.
`MH_BATCH` and `MH_ELL` (defaults 4 and 28) size the batch.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
WORLD = 2
TIMEOUT_S = 400.0                               # the parent's wait for both ranks
B = int(os.environ.get("MH_BATCH", "4"))       # proofs (B / WORLD a process)
ELL = int(os.environ.get("MH_ELL", "28"))


def build_batch():
    """Deterministic batch: every process derives the SAME proofs."""
    from curdleproofs_tpu_torch.curdleproofs import (
        CurdleproofsProof, generate_crs,
    )
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.parallel.batch_verify import ShuffleInstance
    from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

    rng = StdRng.seed_from_u64(3)
    crs = generate_crs(ELL)
    instances, proofs = [], []
    for _ in range(B):
        perm = list(range(ELL))
        rng.shuffle(perm)
        k = rng.rand_fr()
        vec_R = [rng.rand_g1() for _ in range(ELL)]
        vec_S = [rng.rand_g1() for _ in range(ELL)]
        vec_T, vec_U, M, mb = shuffle_permute_and_commit_input(
            crs, vec_R, vec_S, perm, k, rng)
        proofs.append(CurdleproofsProof.new(
            crs, vec_R, vec_S, vec_T, vec_U, M, perm, k, mb, rng))
        instances.append(ShuffleInstance(vec_R, vec_S, vec_T, vec_U, M))
    return crs, instances, proofs


def worker(rank: int, coordinator: str) -> None:
    import torch.distributed as dist

    from curdleproofs_tpu_torch.backend import get_backend
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.parallel.batch_verify import batch_verify
    from curdleproofs_tpu_torch.parallel.distributed import (
        all_hosts_agree, distributed_batch_verify, init_multihost,
        process_slice,
    )

    pid, world = init_multihost(coordinator, WORLD, rank)
    try:
        if (pid, world) != (rank, WORLD):
            raise RuntimeError(f"joined as {(pid, world)}, not "
                               f"{(rank, WORLD)}")
        init_multihost(coordinator, WORLD, rank)      # idempotent re-entry
        crs, instances, proofs = build_batch()
        sl = process_slice(B)
        results = {"rank": pid, "process_count": world,
                   "backend": get_backend().name, "slice": [sl.start, sl.stop]}

        results["valid_pass"] = bool(distributed_batch_verify(
            crs, instances, proofs, StdRng.seed_from_u64(99)))

        # corrupt a proof in rank 1's slice (identically in every process:
        # the full batch must agree across processes)
        bad = instances[B - 1]
        bad.vec_T, bad.vec_U = bad.vec_U, bad.vec_T
        local_ok = bool(batch_verify(crs, instances[sl], proofs[sl],
                                     StdRng.seed_from_u64(99)))
        results["local_ok_corrupt"] = local_ok
        results["corrupt_pass"] = bool(all_hosts_agree(local_ok))
        print("WORKER " + json.dumps(results), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parent(out: pathlib.Path) -> int:
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    t0 = time.time()
    logs = [tempfile.TemporaryFile("w+") for _ in range(WORLD)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--coordinator",
             coordinator], stdout=logs[r], stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(REPO)) for r in range(WORLD)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, t0 + TIMEOUT_S - time.time()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
        wall = time.time() - t0
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
    finally:
        for f in logs:
            f.close()
    workers = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("WORKER ")]
        if p.returncode or not lines:
            print(f"rank {r} exited {p.returncode} with no result; output:\n"
                  f"{text}")
            return 1
        workers.append(json.loads(lines[-1][len("WORKER "):]))
    ok = (all(w["process_count"] == WORLD for w in workers)
          and all(w["valid_pass"] for w in workers)
          and not any(w["corrupt_pass"] for w in workers)
          and workers[0]["local_ok_corrupt"]          # rank 0 slice clean
          and not workers[1]["local_ok_corrupt"])     # rank 1 saw the bad one
    artifact = {"ok": ok, "world": WORLD, "batch": B, "ell": ELL,
                "wall_s": wall, "workers": workers}
    sys.path.insert(0, str(REPO))
    from curdleproofs_tpu_torch.utils.artifacts import write_artifact

    write_artifact(out, artifact)
    print(json.dumps(artifact))
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    help="where the parent writes its JSON artifact")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        worker(args.rank, args.coordinator)
        return 0
    if args.out is None:
        ap.error("--out is required")
    return parent(args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
