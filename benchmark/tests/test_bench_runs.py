"""Whole runs of the harness on the CPU at the tiny size: a sound run is
correct; the control and every fault planted under the timed path are
not; a run that loaded JAX, or that finds no card, prints no result."""

import pytest

from conftest import ROOT, run_cpu

SEED = 3_000_000_019


def _ok(rc, res, err):
    assert rc == 0, err[-3000:]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"] or \
        list(res) == ["correct", "attempted", "failed", "metrics", "device",
                      "breakdown", "checks"]
    return res


@pytest.mark.parametrize("cell,seconds,metric", [
    ("tiny_l4.sync", 10, "verify_proofs_per_s"),
    ("tiny_l4.relay", 1, "prove_proofs_per_s")])
def test_sound_run_is_correct(tiny_root, cell, seconds, metric):
    res = _ok(*run_cpu(tiny_root, "--workload", cell, "--seed", str(SEED),
                       "--seconds", str(seconds), "--trace", "0"))
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", metric}
    assert res["failed"] == 0 and res["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_traced_run_reads_the_spans(tiny_root):
    rc, res, err = run_cpu(tiny_root, "--workload", "tiny_l4.sync", "--seed",
                           str(SEED + 1), "--seconds", "10", "--trace", "1")
    res = _ok(rc, res, err)
    assert res["correct"] is True
    # no card: the device trace's metrics find nothing and stay out
    assert set(res["metrics"]) == {"import_s", "replay_ms_per_proof.verify",
                                   "final_msm_ms.verify"}


@pytest.mark.parametrize("cell,seconds", [("tiny_l4.sync", 10),
                                          ("tiny_l4.relay", 1)])
@pytest.mark.parametrize("how", ["--control", "answer_altered", "half_batch"])
def test_control_and_faults_are_not_correct(tiny_root, cell, seconds, how):
    extra = [how] if how == "--control" else ["--fault", how]
    res = _ok(*run_cpu(tiny_root, "--workload", cell, "--seed",
                       str(SEED + 2), "--seconds", str(seconds), "--trace",
                       "0", *extra))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_a_jax_module_in_the_process_stops_the_result(tiny_root):
    rc, res, err = run_cpu(
        tiny_root, "--workload", "tiny_l4.sync", "--seed", str(SEED),
        "--seconds", "1", "--trace", "0",
        prelude="import sys, types; sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n")
    assert rc != 0 and res is None
    assert "jaxlib" in err


def test_without_a_card_the_command_prints_no_result():
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "whisk_l124.sync_verify", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_forbidden_names_are_compared_whole():
    from harness.hygiene import forbidden_modules

    mods = {"curdleproofs_tpu_torch": 1, "curdleproofs_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen.x": 1, "torch": 1}
    assert forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "curdleproofs_tpu.host": 1})
    assert forbidden_modules(mods) == ["curdleproofs_tpu", "jax"]


def test_benchmark_files_alone_print_no_result(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "_cache",
                                                  "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "whisk_l124.relay_prove", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
