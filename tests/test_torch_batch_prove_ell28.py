"""The port's batched prover at l = 28 (3 instances, table mode, mixed-add
fold) on the CPU: byte-identical to the port's and the JAX package's
sequential provers (see tests/test_torch_batch_prove.py, whose helpers
this file uses).

Tolerance: exact (equal proof bytes)."""

import torch
from test_torch_batch_prove import batched, sequential, sequential_jax

torch.set_num_threads(1)


def test_batch_prove_matches_sequential_ell28():
    _, _, proofs = batched(28, 3)
    got = [p.serialize() for p in proofs]
    assert len(got[0]) == 3488          # the l = 28 proof size
    assert got == sequential(28, 3) == sequential_jax(28, 3)
