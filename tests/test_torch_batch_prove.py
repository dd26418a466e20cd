"""The port's lockstep batched prover (curdleproofs_tpu_torch.parallel.
batch_prove) on the CPU, under `TorchBackend(device="cpu")`: its proofs must
be BYTE-IDENTICAL to sequential `CurdleproofsProof.new` with the same RNGs,
the port's and the JAX package's, and verify (mirrors
tests/test_batch_prove.py, which the JAX package marks slow; these run in
tier-1).

This file: l = 12, 3 instances, table mode with the mixed-add fold (the
defaults), and `batch_prove` raising without a device backend or a card.
The other cases run in files of their own, each a batch prove of plain
arithmetic on the CPU (tens of seconds): l = 28
(`test_torch_batch_prove_ell28.py`), the wave split
(`..._wave.py`), and at l = 12 the other three combinations of table or
slot mode and `madd` (`..._table_full_add.py`, `..._slot.py`,
`..._slot_full_add.py`).  Each runs its batch under
`torch.inference_mode()`, which only spares autograd's bookkeeping.

Tolerance: exact (equal proof bytes)."""

import pytest
import torch

import curdleproofs_tpu.backend as jbackend
from curdleproofs_tpu.curdleproofs import CurdleproofsProof as JProof
from curdleproofs_tpu.curdleproofs import generate_crs as j_generate_crs
from curdleproofs_tpu.host.rng import StdRng as JRng
from curdleproofs_tpu.util import (
    shuffle_permute_and_commit_input as j_commit,
)
from curdleproofs_tpu_torch.backend import HostBackend, use_backend
from curdleproofs_tpu_torch.curdleproofs import CurdleproofsProof, generate_crs
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops.backend import TorchBackend
from curdleproofs_tpu_torch.parallel import batch_prove as bp
from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


def instances(ell, count, seed0=11, *, rng_cls=StdRng,
              commit=shuffle_permute_and_commit_input, gen_crs=generate_crs):
    """(crs, [ProveInstance]) from per-instance seeds, in either package
    (the JAX package's with its own rng, commit and crs), made on the
    host."""
    with use_backend(HostBackend()):
        return _instances(ell, count, seed0, rng_cls, commit, gen_crs)


def _instances(ell, count, seed0, rng_cls, commit, gen_crs):
    crs = gen_crs(ell)
    out = []
    for i in range(count):
        rng = rng_cls.seed_from_u64(seed0 + i)
        vec_R = [rng.rand_g1() for _ in range(ell)]
        vec_S = [rng.rand_g1() for _ in range(ell)]
        permutation = list(range(ell))
        rng.shuffle(permutation)
        k = rng.rand_fr()
        vec_T, vec_U, M, vec_m_blinders = commit(
            crs, vec_R, vec_S, permutation, k, rng)
        out.append(bp.ProveInstance(vec_R, vec_S, vec_T, vec_U, M,
                                    permutation, k, vec_m_blinders, rng))
    return crs, out


def sequential(ell, count, seed0=11) -> list[bytes]:
    """The port's sequential prover on the host, one proof at a time."""
    crs, insts = instances(ell, count, seed0)
    with use_backend(HostBackend()):
        return [CurdleproofsProof.new(
            crs, i.vec_R, i.vec_S, i.vec_T, i.vec_U, i.M, i.permutation, i.k,
            i.vec_m_blinders, i.rng).serialize() for i in insts]


def sequential_jax(ell, count, seed0=11) -> list[bytes]:
    """The JAX package's sequential prover on its host backend."""
    crs, insts = instances(ell, count, seed0, rng_cls=JRng, commit=j_commit,
                           gen_crs=j_generate_crs)
    with jbackend.use_backend(jbackend.HostBackend()):
        return [JProof.new(
            crs, i.vec_R, i.vec_S, i.vec_T, i.vec_U, i.M, i.permutation, i.k,
            i.vec_m_blinders, i.rng).serialize() for i in insts]


def batched(ell, count, seed0=11, *, table=True, madd=True, wave=None,
            monkeypatch=None):
    """(crs, instances, proofs) of one `batch_prove` on the CPU; `table`
    sets CURDLEPROOFS_TABLE (through `monkeypatch`, when given)."""
    if monkeypatch is not None:
        monkeypatch.setenv("CURDLEPROOFS_TABLE", "1" if table else "0")
    assert bp.use_table() == table
    crs, insts = instances(ell, count, seed0)
    with use_backend(TorchBackend(device="cpu")), torch.inference_mode():
        proofs = bp.batch_prove(crs, insts, wave=wave, madd=madd)
    return crs, insts, proofs


@pytest.fixture(scope="module")
def ell12():
    crs, insts, proofs = batched(12, 3)
    timings = dict(bp.batch_prove.last_timings)
    return crs, insts, proofs, timings


@pytest.mark.parametrize("prover", ["port", "jax"])
def test_batch_prove_matches_sequential(ell12, prover):
    _, _, proofs, timings = ell12
    want = (sequential if prover == "port" else sequential_jax)(12, 3)
    assert len(proofs) == 3
    assert [p.serialize() for p in proofs] == want
    # one grouped dispatch each: A/R-hat/S-hat, C, B_c/B_d, 4 IPA rounds,
    # the same-msm B's, 4 same-msm rounds
    assert timings["dispatches"] == 12
    assert {"bases_s", "table_s", "pack_s", "device_s", "decode_s",
            "wave_s", "host_other_s"} <= set(timings)


def test_batch_prove_proofs_verify(ell12):
    crs, insts, proofs, _ = ell12
    vrng = StdRng.seed_from_u64(99)
    with use_backend(HostBackend()):
        for inst, proof in zip(insts, proofs):
            proof.verify(crs, inst.vec_R, inst.vec_S, inst.vec_T,
                         inst.vec_U, inst.M, vrng)


def test_batch_prove_needs_a_device_backend():
    """Without a `TorchBackend` the device is `cuda`: without a card
    `batch_prove` raises, it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    crs, insts = instances(12, 1)
    with use_backend(HostBackend()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bp.batch_prove(crs, insts)
    assert bp.batch_prove(crs, []) == []
