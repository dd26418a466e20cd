"""The port's batched prover at l = 12 in table mode with the
full-add fold (madd=False), on the CPU: one instance, byte-identical to the
sequential prover, as table mode with the mixed-add fold is in
tests/test_torch_batch_prove.py, whose helpers this file uses.

Tolerance: exact (equal proof bytes)."""

import torch
from test_torch_batch_prove import batched, sequential

torch.set_num_threads(1)


def test_batch_prove_table_full_add_matches_sequential(monkeypatch):
    _, _, proofs = batched(12, 1, seed0=21, table=True, madd=False,
                           monkeypatch=monkeypatch)
    assert [p.serialize() for p in proofs] == sequential(12, 1, seed0=21)
