"""The port's example entry points (`curdleproofs_tpu_torch/examples/`, the
JAX package's `examples/`): each `main(argv)` runs in-process at a small
size and completes with its assertions: the Whisk walkthrough and the
chain-sync demo (2 blocks at l = 28) under `CURDLEPROOFS_BACKEND=host`,
the MSM demo with `--device cpu` at 64 points on a (2, 1) grid of CPU
devices; each also as `python3 -m curdleproofs_tpu_torch.examples.<name>`
in a subprocess.  Without a card, each demo's default raises."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from curdleproofs_tpu_torch import backend as backend_mod
from curdleproofs_tpu_torch.examples import (
    chain_sync_demo, msm_demo, whisk_ssle_demo,
)

torch.set_num_threads(1)


@pytest.fixture
def backend_env(monkeypatch):
    """Sets CURDLEPROOFS_BACKEND, resolved afresh by the demo."""
    def use(name):
        if name is None:
            monkeypatch.delenv("CURDLEPROOFS_BACKEND", raising=False)
        else:
            monkeypatch.setenv("CURDLEPROOFS_BACKEND", name)
        monkeypatch.setattr(backend_mod, "_active", None)
    return use


def test_whisk_ssle_demo_on_host(backend_env, capsys):
    backend_env("host")
    assert whisk_ssle_demo.main([]) == 0
    out = capsys.readouterr().out
    assert "backend host" in out
    assert out.count("proof 4496 B") == 2
    assert "opening proof 128 B" in out
    assert "wrong-owner opening rejected: demo complete" in out


def test_chain_sync_demo_on_host(backend_env, capsys):
    backend_env("host")
    assert chain_sync_demo.main(["2", "28"]) == 0
    out = capsys.readouterr().out
    assert "building a 2-block segment at ell=28" in out
    assert "shuffle proofs : serial" in out and "tracker proofs" in out
    assert "segment valid: demo complete" in out


def test_msm_demo_on_cpu_grid(capsys):
    assert msm_demo.main(["--device", "cpu", "--n", "64",
                          "--grid", "2", "1"]) == 0
    out = capsys.readouterr().out
    assert "single-device MSM of 2^6 on cpu" in out
    assert "sharded over grid (2, 1) (1 distinct device(s)): identical " \
        "result" in out


def test_msm_demo_grid_devices():
    cpu = torch.device("cpu")
    assert msm_demo.grid_devices(cpu) == ([cpu] * 8, 2)
    assert msm_demo.grid_devices(cpu, (3, 1)) == ([cpu] * 3, 1)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the defaults where no card is present")
@pytest.mark.parametrize("demo", ["whisk", "chain", "msm"])
def test_demo_defaults_raise_without_a_card(backend_env, demo):
    backend_env(None)
    main, argv = {"whisk": (whisk_ssle_demo.main, []),
                  "chain": (chain_sync_demo.main, ["1", "4"]),
                  "msm": (msm_demo.main, ["--n", "64"])}[demo]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("name, argv, env, done", [
    ("whisk_ssle_demo", [], {"CURDLEPROOFS_BACKEND": "host"},
     "demo complete"),
    ("chain_sync_demo", ["2", "28"], {"CURDLEPROOFS_BACKEND": "host"},
     "segment valid: demo complete"),
    ("msm_demo", ["--device", "cpu", "--n", "64", "--grid", "1", "1"], {},
     "identical result"),
])
def test_demo_runs_as_a_module(name, argv, env, done):
    r = subprocess.run(
        [sys.executable, "-m", f"curdleproofs_tpu_torch.examples.{name}",
         *argv], capture_output=True, text=True, timeout=300,
        cwd=pathlib.Path(__file__).resolve().parents[1],
        env={**os.environ, "OMP_NUM_THREADS": "1", **env})
    assert r.returncode == 0, r.stderr[-3000:]
    assert done in r.stdout
