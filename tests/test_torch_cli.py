"""`python -m curdleproofs_tpu_torch` (the port's CLI): the four tests of
`tests/test_cli.py` against it.  The round trips (crs -> prove -> verify ->
tamper-reject, the batch manifest, the tracker opening) run in-process
through `main(argv)` with `CURDLEPROOFS_BACKEND=host` in the environment,
the backend resolved from it as the CLI resolves it; `info` runs as
`python -m curdleproofs_tpu_torch info` in a subprocess, under the default
backend (which needs a card) and under `host`, and reports the torch
version and that there is no card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from curdleproofs_tpu_torch import backend as backend_mod
from curdleproofs_tpu_torch.__main__ import main
from curdleproofs_tpu_torch.host.g1 import GENERATOR
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.host.serde import g1_to_bytes

torch.set_num_threads(1)

ELL = 28
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def host_env(monkeypatch):
    """CURDLEPROOFS_BACKEND=host, resolved afresh by each command."""
    monkeypatch.setenv("CURDLEPROOFS_BACKEND", "host")
    monkeypatch.setattr(backend_mod, "_active", None)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """All shared artifacts (CRS, trackers, round-1 proof) are built HERE so
    each test runs standalone, in any order."""
    d = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CURDLEPROOFS_BACKEND", "host")
        mp.setattr(backend_mod, "_active", None)
        assert main(["crs", "--ell", str(ELL), "-o", str(d / "crs.json")]) == 0
        rng = StdRng.seed_from_u64(5)
        trk, ks = [], []
        for _ in range(ELL):
            k, r = rng.rand_fr(), rng.rand_fr()
            rG = GENERATOR.mul(r)
            trk.append({"r_G": "0x" + g1_to_bytes(rG).hex(),
                        "k_r_G": "0x" + g1_to_bytes(rG.mul(k)).hex()})
            ks.append(k)
        (d / "pre.json").write_text(json.dumps(trk))
        assert main(["shuffle-prove", "--crs", str(d / "crs.json"),
                     "--pre", str(d / "pre.json"),
                     "--post", str(d / "post.json"),
                     "--proof", str(d / "p.bin"), "--seed", "7"]) == 0
    return d, trk, ks


def test_cli_shuffle_roundtrip(workdir):
    d, _, _ = workdir
    assert main(["shuffle-verify", "--crs", str(d / "crs.json"),
                 "--pre", str(d / "pre.json"), "--post", str(d / "post.json"),
                 "--proof", str(d / "p.bin")]) == 0
    # tamper -> exit 1 (not an exception), whether the flip corrupts a point
    # encoding (SerializationError) or the proof math
    bad = bytearray((d / "p.bin").read_bytes())
    bad[100] ^= 1
    (d / "pbad.bin").write_bytes(bytes(bad))
    assert main(["shuffle-verify", "--crs", str(d / "crs.json"),
                 "--pre", str(d / "pre.json"), "--post", str(d / "post.json"),
                 "--proof", str(d / "pbad.bin")]) == 1


def test_cli_shuffle_verify_batch(workdir):
    d, _, _ = workdir
    # chain two shuffles: round 2's pre = round 1's post
    assert main(["shuffle-prove", "--crs", str(d / "crs.json"),
                 "--pre", str(d / "post.json"), "--post", str(d / "post2.json"),
                 "--proof", str(d / "p2.bin"), "--seed", "8"]) == 0
    manifest = [{"pre": "pre.json", "post": "post.json", "proof": "p.bin"},
                {"pre": "post.json", "post": "post2.json", "proof": "p2.bin"}]
    (d / "chain.json").write_text(json.dumps(manifest))
    assert main(["shuffle-verify-batch", "--crs", str(d / "crs.json"),
                 "--manifest", str(d / "chain.json")]) == 0
    # corrupt block 1 -> exit 1
    manifest[1]["proof"] = "pbad2.bin"
    bad = bytearray((d / "p2.bin").read_bytes())
    bad[-1] ^= 1
    (d / "pbad2.bin").write_bytes(bytes(bad))
    (d / "chain.json").write_text(json.dumps(manifest))
    assert main(["shuffle-verify-batch", "--crs", str(d / "crs.json"),
                 "--manifest", str(d / "chain.json")]) == 1


def test_cli_tracker_roundtrip(workdir):
    d, trk, ks = workdir
    kG = "0x" + g1_to_bytes(GENERATOR.mul(ks[0])).hex()
    assert main(["tracker-prove", "--r-g", trk[0]["r_G"],
                 "--k-r-g", trk[0]["k_r_G"], "--k", hex(ks[0]),
                 "--proof", str(d / "t.bin"), "--seed", "9"]) == 0
    assert main(["tracker-verify", "--r-g", trk[0]["r_G"],
                 "--k-r-g", trk[0]["k_r_G"], "--k-commitment", kG,
                 "--proof", str(d / "t.bin")]) == 0
    # wrong k-commitment rejects
    wrong = "0x" + g1_to_bytes(GENERATOR.mul(ks[1])).hex()
    assert main(["tracker-verify", "--r-g", trk[0]["r_G"],
                 "--k-r-g", trk[0]["k_r_G"], "--k-commitment", wrong,
                 "--proof", str(d / "t.bin")]) == 1


@pytest.mark.parametrize("backend", ["host", None])
def test_cli_info(backend):
    env = {k: v for k, v in os.environ.items()
           if k != "CURDLEPROOFS_BACKEND"}
    if backend is not None:
        env["CURDLEPROOFS_BACKEND"] = backend
    r = subprocess.run([sys.executable, "-m", "curdleproofs_tpu_torch",
                        "info"], capture_output=True, text=True, cwd=ROOT,
                       env={**env, "OMP_NUM_THREADS": "1"}, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout)
    assert {"backend", "native_runtime", "torch", "device",
            "kernels_built"} <= set(out)
    assert out["torch"] == torch.__version__
    if torch.cuda.is_available():
        assert out["device"] == torch.cuda.get_device_name(0)
    else:
        assert out["device"].startswith("none")
    if backend == "host":
        assert out["backend"] == "host"
    elif not torch.cuda.is_available():   # the default backend needs a card
        assert out["backend"].startswith("torch (unavailable")
