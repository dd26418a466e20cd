"""The port's streamed device MSM and batch verification against the JAX
package and the host model on the CPU (mirrors tests/test_batch_verify.py
and tests/test_whisk_batch.py).

- `DeviceMsmStream(64, device="cpu")` equals the JAX package's
  `DeviceMsmStream(64)` and `HostBackend().msm`, for int scalars, raw
  bytes and the async worker; a worker whose dispatch raises makes
  `result()` raise without hanging, and a stream reused after `result()`
  loses no terms;
- `batch_verify` under `TorchBackend(device="cpu")` gives the JAX
  package's verdicts on the same seeded batch (valid, one bad, identify,
  streamed with chunk 2), under both extremes of a tune table keyed
  "cpu", and raises, rather than returning False, on a device fault;
- `is_valid_whisk_shuffle_proofs` accepts a 4-block chain at l = 28 and
  names the corrupted block.

Tolerance: exact (point equality, equal verdicts, equal proof bytes)."""

import json
import threading

import pytest
import torch

import curdleproofs_tpu.backend as jbackend
from curdleproofs_tpu.curdleproofs import CurdleproofsProof as JProof
from curdleproofs_tpu.curdleproofs import generate_crs as j_generate_crs
from curdleproofs_tpu.host.rng import StdRng as JRng
from curdleproofs_tpu.host.serde import g1_to_bytes as j_g1_to_bytes
from curdleproofs_tpu.ops.msm_device import DeviceMsmStream as JStream
from curdleproofs_tpu.parallel.batch_verify import (
    ShuffleInstance as JInstance,
)
from curdleproofs_tpu.parallel.batch_verify import batch_verify as j_batch
from curdleproofs_tpu.util import (
    shuffle_permute_and_commit_input as j_commit,
)
from curdleproofs_tpu.whisk import WhiskTracker as JTracker
from curdleproofs_tpu.whisk import (
    is_valid_whisk_shuffle_proofs as j_whisk_batch,
)
from curdleproofs_tpu_torch.backend import HostBackend, use_backend
from curdleproofs_tpu_torch.constants import N_BLINDERS
from curdleproofs_tpu_torch.curdleproofs import CurdleproofsProof, generate_crs
from curdleproofs_tpu_torch.host.g1 import GENERATOR
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.host.serde import g1_to_bytes
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops import msm_tune
from curdleproofs_tpu_torch.ops.backend import TorchBackend
from curdleproofs_tpu_torch.parallel import batch_verify as bv
from curdleproofs_tpu_torch.util import shuffle_permute_and_commit_input
from curdleproofs_tpu_torch.whisk import (
    WhiskTracker, generate_whisk_shuffle_proof, is_valid_whisk_shuffle_proofs,
)

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

CPU = TorchBackend(device="cpu")


# --------------------------------------------------------------------------
# the stream
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def terms():
    """150 terms, their host MSM, and the JAX package's stream result."""
    rng = StdRng.seed_from_u64(9)
    pts = [rng.rand_g1() for _ in range(150)]
    ss = [rng.rand_fr() for _ in range(150)]
    jrng = JRng.seed_from_u64(9)
    jpts = [jrng.rand_g1() for _ in range(150)]
    js = JStream(64)
    js.add(jpts[:100], ss[:100])
    js.add(jpts[100:], ss[100:])
    return pts, ss, HostBackend().msm(pts, ss), j_g1_to_bytes(js.result())


@pytest.mark.parametrize("mode", ["ints", "raw", "async"])
def test_stream_matches_jax_and_host(terms, mode):
    pts, ss, want, jax_want = terms
    assert g1_to_bytes(want) == jax_want
    stream = md.DeviceMsmStream(64, async_worker=mode == "async",
                                device="cpu")
    sc = (b"".join(s.to_bytes(32, "little") for s in ss) if mode == "raw"
          else ss)
    cut = 100 * 32 if mode == "raw" else 100
    stream.add(pts[:100], sc[:cut])   # oversized: splits into 64 + 36
    stream.add(pts[100:], sc[cut:])
    assert stream.result() == want
    assert stream.dispatches == 3     # 64, 64 and the tail of 22


@pytest.mark.parametrize("async_worker", [False, True])
def test_stream_reused_after_result_loses_no_terms(terms, async_worker):
    pts, ss, _, _ = terms
    host = HostBackend()
    stream = md.DeviceMsmStream(64, async_worker=async_worker, device="cpu")
    stream.add(pts[:70], ss[:70])
    assert stream.result() == host.msm(pts[:70], ss[:70])
    stream.add(pts[70:100], ss[70:100])
    assert stream.result() == host.msm(pts[:100], ss[:100])


def test_stream_worker_fault_raises_in_result(terms, monkeypatch):
    """A dispatch that raises on the worker: `add()` never blocks on the
    bounded queue (more chunks than its 4 places follow the fault), and
    `result()` raises the error, on every call."""
    pts, ss, _, _ = terms
    calls = []

    def broken(bases, scalars, params, mark=None, madd=True):
        calls.append(1)
        raise RuntimeError("device fault")

    monkeypatch.setattr(md, "_dispatch_pipeline", broken)
    stream = md.DeviceMsmStream(16, async_worker=True, device="cpu")
    errors = []

    def run():
        stream.add(pts[:144], ss[:144])   # 9 chunks of 16
        try:
            stream.result()
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the stream hung after a worker fault"
    assert [str(e) for e in errors] == ["device fault"]
    assert len(calls) == 1            # later chunks were drained, not run
    with pytest.raises(RuntimeError, match="device fault"):
        stream.result()


def test_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        md.DeviceMsmStream(64)


# --------------------------------------------------------------------------
# batch verification
# --------------------------------------------------------------------------

ELL = 16 - N_BLINDERS


def _make_batch(rng_cls, gen_crs, commit, proof_cls, inst_cls):
    rng = rng_cls.seed_from_u64(0)
    crs = gen_crs(ELL)
    instances, proofs = [], []
    for _ in range(3):
        perm = list(range(ELL))
        rng.shuffle(perm)
        k = rng.rand_fr()
        vec_R = [rng.rand_g1() for _ in range(ELL)]
        vec_S = [rng.rand_g1() for _ in range(ELL)]
        vec_T, vec_U, M, mb = commit(crs, vec_R, vec_S, perm, k, rng)
        proofs.append(proof_cls.new(crs, vec_R, vec_S, vec_T, vec_U, M,
                                    perm, k, mb, rng))
        instances.append(inst_cls(vec_R, vec_S, vec_T, vec_U, M))
    return crs, instances, proofs, rng


def _tampered(instances, inst_cls):
    b = instances[1]
    return [instances[0], inst_cls(b.vec_S, b.vec_R, b.vec_T, b.vec_U, b.M),
            instances[2]]


@pytest.fixture(scope="module")
def batches():
    with jbackend.use_backend(jbackend.HostBackend()):
        jb = _make_batch(JRng, j_generate_crs, j_commit, JProof, JInstance)
    with use_backend(HostBackend()):
        tb = _make_batch(StdRng, generate_crs,
                         shuffle_permute_and_commit_input, CurdleproofsProof,
                         bv.ShuffleInstance)
    assert [p.serialize() for p in tb[2]] == [p.serialize() for p in jb[2]]
    return jb, tb


_CASES = {
    "valid": (False, {}),
    "one_bad": (True, {}),
    "identify": (True, {"identify": True}),
    "streamed_valid": (False, {"stream_chunk": 2}),
    "streamed_bad": (True, {"stream_chunk": 2}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_batch_verify_matches_jax(batches, case):
    (jcrs, jinst, jproofs, jrng), (crs, inst, proofs, rng) = batches
    bad, kw = _CASES[case]
    if bad:
        jinst, inst = _tampered(jinst, JInstance), _tampered(
            inst, bv.ShuffleInstance)
    with jbackend.use_backend(jbackend.HostBackend()):
        want = j_batch(jcrs, jinst, jproofs, jrng, **kw)
    with use_backend(CPU):
        got = bv.batch_verify(crs, inst, proofs, rng, **kw)
    assert got == want
    assert want == ([True, False, True] if "identify" in kw else not bad)


@pytest.mark.parametrize("rates,expect_f", [
    ({"host_ms": 1000.0, "device_warm_ms": 1.0, "fresh_prep_ms": 1.0}, 1.0),
    ({"host_ms": 1.0, "device_warm_ms": 500.0, "fresh_prep_ms": 500.0}, 0.0),
])
def test_streamed_split_extremes(batches, tmp_path, monkeypatch, rates,
                                 expect_f):
    """A tune table keyed "cpu" drives the split to each extreme; both
    verify the batch and reject the tampered one."""
    params = md.stream_params()
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"cpu": {str(params.n): {"c": params.c,
                                                        **rates}}}))
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(path))
    msm_tune._load_raw.cache_clear()
    try:
        assert msm_tune.load_table("cuda") == {}
        f = bv.plan_split_fraction(device="cpu")
        assert abs(f - expect_f) < 0.01, f
        _, (crs, inst, proofs, rng) = batches
        with use_backend(CPU):
            assert bv.batch_verify(crs, inst, proofs, rng,
                                   stream_chunk=1) is True
            assert bv._batch_verify_streamed.last_stats["dispatches"] >= 1
            assert bv.batch_verify(
                crs, _tampered(inst, bv.ShuffleInstance), proofs, rng,
                stream_chunk=1) is False
    finally:
        msm_tune._load_raw.cache_clear()


def test_untuned_split_is_half(tmp_path, monkeypatch):
    """Untuned (`CURDLEPROOFS_TUNE` naming an absent file), every device
    type splits 50/50."""
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(tmp_path / "absent.json"))
    msm_tune._load_raw.cache_clear()
    try:
        assert not msm_tune.table_path().exists()
        for device in ("cpu", "cuda"):
            assert msm_tune.load_table(device) == {}
            assert bv.plan_split_fraction(device=device) == 0.5
    finally:
        msm_tune._load_raw.cache_clear()


def test_device_fault_is_raised_not_a_verdict(batches, monkeypatch):
    """Only VerificationError means invalid: a fault in the device MSM
    propagates from the streamed and the one-MSM paths."""
    _, (crs, inst, proofs, rng) = batches

    def broken(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(md, "_dispatch_pipeline", broken)
    with use_backend(CPU):
        with pytest.raises(RuntimeError, match="device fault"):
            bv.batch_verify(crs, inst, proofs, rng, stream_chunk=2)
        with pytest.raises(RuntimeError, match="device fault"):
            bv.batch_verify(crs, inst, proofs, rng)


def test_stream_runs_on_the_backends_device():
    with use_backend(CPU):
        assert bv.active_device() == torch.device("cpu")
    if not torch.cuda.is_available():
        with use_backend(HostBackend()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                bv.active_device()


# --------------------------------------------------------------------------
# the Whisk chain
# --------------------------------------------------------------------------

WHISK_ELL = 28


@pytest.fixture(scope="module")
def chain():
    """A 4-block Whisk chain (block k's post = block k+1's pre), made on
    the host backend."""
    rng = StdRng.seed_from_u64(31)
    crs = generate_crs(WHISK_ELL)
    trackers = []
    for _ in range(WHISK_ELL):
        k, r = rng.rand_fr(), rng.rand_fr()
        r_G = GENERATOR.mul(r)
        trackers.append(WhiskTracker(g1_to_bytes(r_G),
                                     g1_to_bytes(r_G.mul(k))))
    shuffles = []
    with use_backend(HostBackend()):
        for _ in range(4):
            post, proof = generate_whisk_shuffle_proof(rng, crs, trackers)
            shuffles.append((trackers, post, proof))
            trackers = post
    return rng, crs, shuffles


def _jax_verdict(crs, shuffles, identify):
    jcrs = j_generate_crs(WHISK_ELL)
    assert [j_g1_to_bytes(p) for p in jcrs.vec_G] == [
        g1_to_bytes(p) for p in crs.vec_G]
    js = [([JTracker(t.r_G, t.k_r_G) for t in pre],
           [JTracker(t.r_G, t.k_r_G) for t in post], proof)
          for pre, post, proof in shuffles]
    with jbackend.use_backend(jbackend.HostBackend()):
        return j_whisk_batch(JRng.seed_from_u64(5), jcrs, js,
                             identify=identify)


def test_whisk_batch_accepts_chain(chain):
    rng, crs, shuffles = chain
    with use_backend(TorchBackend(device="cpu")) as b:
        assert is_valid_whisk_shuffle_proofs(rng, crs, shuffles) is True
        assert b.engine_counts["device"] == 1
    assert _jax_verdict(crs, shuffles, False) is True


def test_whisk_batch_identifies_bad_block(chain):
    rng, crs, shuffles = chain
    shuffles = list(shuffles)
    pre, post, proof = shuffles[2]
    bad = bytearray(proof)
    bad[-1] ^= 1                      # corrupt a scalar tail byte
    shuffles[2] = (pre, post, bytes(bad))
    with use_backend(CPU):
        assert not is_valid_whisk_shuffle_proofs(rng, crs, shuffles)
        verdicts = is_valid_whisk_shuffle_proofs(rng, crs, shuffles,
                                                 identify=True)
    assert verdicts == [True, True, False, True]
    assert _jax_verdict(crs, shuffles, True) == verdicts
