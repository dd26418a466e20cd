"""End-to-end Whisk SSLE walkthrough (the JAX package's
`examples/whisk_ssle_demo.py`: the reference's consensus simulation,
whisk.rs:460-607, as a runnable demo).

A validator set registers trackers, proposers shuffle the candidate set with
curdleproofs shuffle proofs, and the elected proposer proves tracker ownership
with a 128-byte DLEQ opening proof.

    python3 -m curdleproofs_tpu_torch.examples.whisk_ssle_demo   # the card
    CURDLEPROOFS_BACKEND=host \\
        python3 -m curdleproofs_tpu_torch.examples.whisk_ssle_demo   # the CPU

The proofs' MSMs run on the active backend (`CURDLEPROOFS_BACKEND`, default
`torch`, which raises without a card).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..backend import get_backend
from ..curdleproofs import generate_crs
from ..host.g1 import GENERATOR
from ..host.rng import StdRng
from ..host.serde import g1_from_bytes, g1_to_bytes
from ..whisk import (
    WhiskTracker,
    generate_whisk_shuffle_proof,
    generate_whisk_tracker_proof,
    is_valid_whisk_shuffle_proof,
    is_valid_whisk_tracker_proof,
)

ELL = 124  # the Whisk candidate-set size (whisk.rs:28-29: N=128, ELL=124)


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    # resolved before any work: a backend that needs a card raises here
    backend = get_backend()
    print(f"backend {backend.name} on "
          f"{getattr(backend, 'device', 'the host')}")
    rng = StdRng.seed_from_u64(2026)
    ell = ELL
    crs = generate_crs(ell)

    # --- registration: each validator commits k*G and a tracker (r*G, k*r*G)
    print(f"registering {ell} validators ...")
    secrets, trackers, k_commitments = [], [], []
    for _ in range(ell):
        k = rng.rand_fr()
        r = rng.rand_fr()
        r_G = GENERATOR.mul(r)
        trackers.append(WhiskTracker(g1_to_bytes(r_G),
                                     g1_to_bytes(r_G.mul(k))))
        k_commitments.append(g1_to_bytes(GENERATOR.mul(k)))
        secrets.append(k)

    # --- two shuffle rounds: proposers permute + re-randomize the candidates
    for rnd in (1, 2):
        t0 = time.perf_counter()
        post, proof = generate_whisk_shuffle_proof(rng, crs, trackers)
        t1 = time.perf_counter()
        ok = is_valid_whisk_shuffle_proof(rng, crs, trackers, post, proof)
        t2 = time.perf_counter()
        assert ok, "shuffle proof rejected"
        print(f"round {rnd}: shuffled {ell} trackers, proof {len(proof)} B, "
              f"prove {1e3*(t1-t0):.0f} ms, verify {1e3*(t2-t1):.0f} ms")
        trackers = post

    # --- election: the proposer matching tracker 0 proves ownership
    # (find which validator owns the shuffled tracker by trial: the demo
    # plays omniscient; a real validator just recognises its own k)
    elected = trackers[0]
    r_G = g1_from_bytes(elected.r_G)
    owner = next(i for i, k in enumerate(secrets)
                 if r_G.mul(k) == g1_from_bytes(elected.k_r_G))
    t0 = time.perf_counter()
    opening = generate_whisk_tracker_proof(rng, elected, secrets[owner])
    t1 = time.perf_counter()
    assert is_valid_whisk_tracker_proof(elected, k_commitments[owner], opening)
    t2 = time.perf_counter()
    print(f"validator {owner} elected; opening proof {len(opening)} B, "
          f"prove {1e3*(t1-t0):.1f} ms, verify {1e3*(t2-t1):.1f} ms")
    # a wrong secret must not verify
    assert not is_valid_whisk_tracker_proof(
        elected, k_commitments[(owner + 1) % ell], opening)
    print("wrong-owner opening rejected: demo complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
