"""The port's batched prover split into waves (l = 12, 3 instances, two
proofs a residency): the same bytes as the sequential prover, so the
residency split is transparent (see tests/test_torch_batch_prove.py, whose
helpers this file uses).

Tolerance: exact (equal proof bytes)."""

import torch
from test_torch_batch_prove import batched, sequential
from curdleproofs_tpu_torch.parallel import batch_prove as bp

torch.set_num_threads(1)


def test_batch_prove_wave_split():
    _, _, proofs = batched(12, 3, seed0=5, wave=2)
    # two waves of 12 dispatches each; the timings are the last wave's
    assert bp.batch_prove.last_timings["dispatches"] == 12
    assert [p.serialize() for p in proofs] == sequential(12, 3, seed0=5)
