"""A later change adds a configuration, a mix and a metric as new files
and new entries of BENCHMARK.json, and edits no file the benchmark has."""

import hashlib
import json

from conftest import copy_benchmark, run_cpu


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "_build" not in p.parts and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_need_no_edit(tmp_path):
    root = copy_benchmark(tmp_path)
    before = _digests(root)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "whisk_l124.json").read_text())
    cfg.update(name="whisk_l4", ell=4, n=8, reduced=["ell", "n"])
    (b / "configs" / "whisk_l4.json").write_text(json.dumps(cfg))
    (b / "traffic" / "sync_valid_only.json").write_text(json.dumps({
        "entry": "whisk_batch_verify", "why": "valid batches of 2 blocks",
        "params": {"blocks_per_batch": 2}, "period": {"valid": 1},
        "env": {"CP_NO_DECOMPRESS_CACHE": "1"}}))
    (b / "metrics" / "calls_per_s.verify.py").write_text(
        "def read(run):\n    return run.calls / run.window_s\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    cell = "whisk_l4.sync_valid_only"
    man["configs"].append({"name": "whisk_l4", "source": "a test size",
                           "file": "benchmark/configs/whisk_l4.json",
                           "reduced": ["ell", "n"], "why": "the extension test"})
    man["workloads"].append({"name": cell, "config": "whisk_l4",
                             "traffic": "sync_valid_only", "chips": 1,
                             "why": "the extension test"})
    man["per_layer"].append({"name": "calls_per_s.verify", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "protocol and batch",
                             "moves": "verify_proofs_per_s",
                             "workloads": [cell]})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("verify_proofs_per_s", "import_s"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    rc, res, err = run_cpu(root, "--workload", cell, "--seed", "77",
                           "--seconds", "2", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert res["metrics"]["calls_per_s.verify"]["unit"] == "1/s"
    assert res["metrics"]["calls_per_s.verify"]["value"] > 0
    after = _digests(root)
    assert {k: after[k] for k in before} == before
