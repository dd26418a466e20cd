"""The port's process-group helpers (parallel/distributed.py) in their
single-process form: the three tests of tests/test_distributed.py, with the
mesh a grid of CPU devices (the counterpart of conftest's 8 virtual CPU
devices) and the MSMs on the host backend, where the JAX package's `auto`
backend puts them without a TPU; plus the grid's refusal without a card,
and `distributed_batch_verify` with a grid, whose sharded final MSM must
give the same verdicts.  Verdicts compare exactly."""

import pytest
import torch

from curdleproofs_tpu_torch.backend import HostBackend, use_backend
from curdleproofs_tpu_torch.curdleproofs import CurdleproofsProof, generate_crs
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.parallel.batch_verify import ShuffleInstance
from curdleproofs_tpu_torch.parallel.distributed import (
    all_hosts_agree, distributed_batch_verify, global_mesh, init_multihost,
    process_slice,
)
from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def test_single_process_group():
    rank, world = init_multihost()
    assert (rank, world) == (0, 1)
    assert process_slice(10) == slice(0, 10)
    assert all_hosts_agree(True) is True
    assert all_hosts_agree(False) is False


def test_global_mesh_axes(monkeypatch):
    mesh = global_mesh(n_window_shards=2, devices=CPU8)
    assert mesh.axis_names == ("points", "windows")
    assert mesh.devices.shape == (len(CPU8) // 2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        global_mesh()


@pytest.fixture(scope="module")
def batch():
    ell = 28
    rng = StdRng.seed_from_u64(5)
    crs = generate_crs(ell)
    insts, proofs = [], []
    with use_backend(HostBackend()):
        for _ in range(3):
            perm = list(range(ell))
            rng.shuffle(perm)
            k = rng.rand_fr()
            R = [rng.rand_g1() for _ in range(ell)]
            S = [rng.rand_g1() for _ in range(ell)]
            T, U, M, mb = shuffle_permute_and_commit_input(crs, R, S, perm, k,
                                                           rng)
            proofs.append(
                CurdleproofsProof.new(crs, R, S, T, U, M, perm, k, mb, rng))
            insts.append(ShuffleInstance(R, S, T, U, M))
    # tamper: swap one instance's T/U
    bad = list(insts)
    bad[1] = ShuffleInstance(insts[1].vec_R, insts[1].vec_S, insts[1].vec_U,
                             insts[1].vec_T, insts[1].M)
    return crs, insts, bad, proofs, rng


@pytest.mark.parametrize("grid", [None, (2, 1)], ids=["no_mesh", "mesh_2x1"])
def test_distributed_batch_verify_single_process(batch, grid):
    crs, insts, bad, proofs, rng = batch
    mesh = None if grid is None else global_mesh(
        n_window_shards=grid[1], devices=CPU8[:grid[0] * grid[1]])
    with use_backend(HostBackend()):
        assert distributed_batch_verify(crs, insts, proofs, rng, mesh)
        assert not distributed_batch_verify(crs, bad, proofs, rng, mesh)


def test_init_needs_the_whole_address(monkeypatch):
    monkeypatch.delenv("CURDLEPROOFS_COORDINATOR", raising=False)
    monkeypatch.setenv("CURDLEPROOFS_NPROCS", "2")
    with pytest.raises(ValueError, match="coordinator"):
        init_multihost()
