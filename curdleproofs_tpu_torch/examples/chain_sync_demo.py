"""Chain-sync batch verification demo (the JAX package's
`examples/chain_sync_demo.py`; no reference analogue: whisk.rs verifies one
shuffle per call).

A syncing node validates a segment of Whisk shuffle blocks at once:
every proof's deferred checks share ONE accumulated MSM, consecutive
blocks' tracker lists overlap (block k's post == block k+1's pre) so the
validated-decompress cache collapses their sqrt + subgroup ladders, and a
block's worth of tracker opening proofs verifies as a single ~(5B+1)-base
MSM.

    python3 -m curdleproofs_tpu_torch.examples.chain_sync_demo [n_blocks] [ell]
    CURDLEPROOFS_BACKEND=host \\
        python3 -m curdleproofs_tpu_torch.examples.chain_sync_demo 2 28

The MSMs run on the active backend (`CURDLEPROOFS_BACKEND`, default
`torch`, which raises without a card).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..backend import get_backend
from ..curdleproofs import generate_crs
from ..host import serde
from ..host.g1 import GENERATOR
from ..host.rng import StdRng
from ..host.serde import g1_to_bytes
from ..whisk import (
    WhiskTracker,
    generate_whisk_shuffle_proof,
    generate_whisk_tracker_proof,
    is_valid_whisk_shuffle_proof,
    is_valid_whisk_shuffle_proofs,
    is_valid_whisk_tracker_proof,
    is_valid_whisk_tracker_proofs,
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_blocks", type=int, nargs="?", default=8)
    ap.add_argument("ell", type=int, nargs="?", default=124)
    args = ap.parse_args(argv)
    n_blocks, ell = args.n_blocks, args.ell
    # resolved before any work: a backend that needs a card raises here
    backend = get_backend()
    print(f"backend {backend.name} on "
          f"{getattr(backend, 'device', 'the host')}")
    rng = StdRng.seed_from_u64(7)
    crs = generate_crs(ell)

    print(f"building a {n_blocks}-block segment at ell={ell} ...")
    secrets, trackers, commitments = [], [], []
    for _ in range(ell):
        k, r = rng.rand_fr(), rng.rand_fr()
        r_G = GENERATOR.mul(r)
        trackers.append(WhiskTracker(g1_to_bytes(r_G),
                                     g1_to_bytes(r_G.mul(k))))
        commitments.append(g1_to_bytes(GENERATOR.mul(k)))
        secrets.append(k)
    shuffles = []
    for _ in range(n_blocks):
        post, proof = generate_whisk_shuffle_proof(rng, crs, trackers)
        shuffles.append((trackers, post, proof))
        trackers = post
    openings = [generate_whisk_tracker_proof(rng, t, k)
                for t, k in zip(shuffles[0][0], secrets)]

    # --- shuffle proofs: serial vs one-MSM batch
    serde._CACHE.clear()
    t0 = time.perf_counter()
    for pre, post, proof in shuffles:
        assert is_valid_whisk_shuffle_proof(rng, crs, pre, post, proof)
    t_serial = time.perf_counter() - t0
    serde._CACHE.clear()
    t0 = time.perf_counter()
    assert is_valid_whisk_shuffle_proofs(rng, crs, shuffles)
    t_batch = time.perf_counter() - t0
    print(f"shuffle proofs : serial {1e3 * t_serial:.0f} ms "
          f"({1e3 * t_serial / n_blocks:.1f}/blk) -> "
          f"batch {1e3 * t_batch:.0f} ms "
          f"({1e3 * t_batch / n_blocks:.1f}/blk), "
          f"{t_serial / t_batch:.2f}x")

    # --- tracker openings: serial vs one-MSM batch
    pre0 = shuffles[0][0]
    t0 = time.perf_counter()
    for t, c, p in zip(pre0, commitments, openings):
        assert is_valid_whisk_tracker_proof(t, c, p)
    t_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert is_valid_whisk_tracker_proofs(pre0, commitments, openings, rng)
    t_batch = time.perf_counter() - t0
    print(f"tracker proofs : serial {1e3 * t_serial:.0f} ms -> "
          f"batch {1e3 * t_batch:.0f} ms "
          f"({1e3 * t_batch / ell:.2f} ms/proof), "
          f"{t_serial / t_batch:.1f}x")
    print("segment valid: demo complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
