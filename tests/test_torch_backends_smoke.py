"""Prove + verify under every port backend on the CPU, and `msm_raw` on each
(`tests/test_backends_smoke.py` against the port).

The round trip runs at l = 28 on the instance of `tests/test_torch_protocol.py`
(`StdRng.seed_from_u64(42)`), so the proof bytes of `HostBackend`,
`PurePythonBackend`, `HybridBackend` and the all-device `DeviceBackend`
(the last two on `device="cpu"`: kernels' plain versions) are each held to
the JAX package's host proof from the same seed, byte for byte, as that
file holds `TorchBackend`'s: the four backends and `TorchBackend` give one
proof.  (`TorchBackend` is left out here: its l = 28 prove on the CPU, every
folding round's MSM through the plain pipeline, takes over a minute and is
already that file's test, with the tamper check.)  The instance is made on
the host backend; every proof verifies under its own backend.  Tolerance:
exact."""

import pytest
import torch

import curdleproofs_tpu.backend as jbackend
from curdleproofs_tpu.curdleproofs import CurdleproofsProof as JProof
from curdleproofs_tpu.curdleproofs import generate_crs as j_generate_crs
from curdleproofs_tpu.host.rng import StdRng as JRng
from curdleproofs_tpu.util import (
    shuffle_permute_and_commit_input as j_commit,
)
from curdleproofs_tpu_torch.backend import (
    HostBackend, PurePythonBackend, use_backend,
)
from curdleproofs_tpu_torch.constants import N_BLINDERS
from curdleproofs_tpu_torch.curdleproofs import CurdleproofsProof, generate_crs
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops.backend import (
    DeviceBackend, HybridBackend, TorchBackend,
)
from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input

torch.set_num_threads(1)

ELL = 32 - N_BLINDERS  # N = 32
BACKENDS = {
    "host": HostBackend,
    "pure": PurePythonBackend,
    "hybrid": lambda: HybridBackend(device="cpu"),
    "device": lambda: DeviceBackend(device="cpu"),
}


def _instance(rng_cls, gen_crs, commit):
    rng = rng_cls.seed_from_u64(42)
    crs = gen_crs(ELL)
    perm = list(range(ELL))
    rng.shuffle(perm)
    k = rng.rand_fr()
    vec_r = [rng.rand_g1() for _ in range(ELL)]
    vec_s = [rng.rand_g1() for _ in range(ELL)]
    T, U, M, mb = commit(crs, vec_r, vec_s, perm, k, rng)
    return rng, crs, vec_r, vec_s, T, U, M, perm, k, mb


@pytest.fixture(scope="module")
def jax_proof() -> bytes:
    rng, crs, vr, vs, T, U, M, perm, k, mb = _instance(
        JRng, j_generate_crs, j_commit)
    with jbackend.use_backend(jbackend.HostBackend()):
        return JProof.new(crs, vr, vs, T, U, M, perm, k, mb, rng).serialize()


@pytest.mark.parametrize("name", BACKENDS)
def test_round_trip_every_backend(name, jax_proof):
    with use_backend(HostBackend()):
        rng, crs, vr, vs, T, U, M, perm, k, mb = _instance(
            StdRng, generate_crs, shuffle_permute_and_commit_input)
    backend = BACKENDS[name]()
    with use_backend(backend):
        proof = CurdleproofsProof.new(crs, vr, vs, T, U, M, perm, k, mb, rng)
        assert proof.serialize() == jax_proof
        proof.verify(crs, vr, vs, T, U, M, rng)
    if name == "hybrid":   # untuned: every MSM of this size on the host
        assert backend.engine_counts["device"] == 0
        assert backend.engine_counts["host"] > 0
    if name == "device":
        assert backend.engine_counts["device"] > 0


def test_msm_raw_every_backend():
    """msm_raw (canonical 32 B-LE scalars) matches msm on every backend; the
    hybrid backend routes sub-threshold sizes to the host engine."""
    rng = StdRng.seed_from_u64(4)
    n = 48
    pts = [rng.rand_g1() for _ in range(n)]
    ss = [rng.rand_fr() for _ in range(n)]
    sb = b"".join(s.to_bytes(32, "little") for s in ss)
    expect = HostBackend().msm(pts, ss)
    made = {name: make() for name, make in BACKENDS.items()}
    for b in made.values():
        assert b.msm_raw(pts, sb) == expect
    # TorchBackend's msm_raw, which DeviceBackend and HybridBackend inherit,
    # runs the device pipeline above (tests/test_torch_protocol.py also
    # calls it); a short buffer raises on all three before any work
    made["torch"] = TorchBackend(device="cpu")
    for name in ("hybrid", "device", "torch"):
        with pytest.raises(ValueError):
            made[name].msm_raw(pts, sb[:-1])
    assert made["hybrid"].last_msm_engine == "host"  # n < the threshold
    assert made["device"].last_msm_engine == "device"
