"""Fixtures of the benchmark's own tests: a copy of the benchmark at a
tiny size (n = 8), which the harness runs on the CPU with the program's
plain versions.  Run them with `python -m pytest benchmark/tests -q`."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = {"tiny_l4.sync": "tiny_sync", "tiny_l4.relay": "tiny_relay"}


def copy_benchmark(dest: pathlib.Path) -> pathlib.Path:
    """A checkout-like root: the benchmark's files copied, the program
    linked, the native build shared (its directory is keyed by the
    sources, so sharing it is safe)."""
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns(
        "_build", "_cache", "__pycache__", "tests"))
    (BENCH / "_build").mkdir(exist_ok=True)
    (dest / "benchmark" / "_build").symlink_to(BENCH / "_build")
    (dest / "curdleproofs_tpu_torch").symlink_to(ROOT / "curdleproofs_tpu_torch")
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def add_tiny(root: pathlib.Path) -> None:
    """A tiny configuration (ell = 4) and two tiny mixes, as new files
    and manifest entries."""
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "whisk_l124.json").read_text())
    cfg.update(name="tiny_l4", ell=4, n=8)
    (b / "configs" / "tiny_l4.json").write_text(json.dumps(cfg))
    for mix, src, params in (("tiny_sync", "sync_verify", {"blocks_per_batch": 4}),
                             ("tiny_relay", "relay_prove", {"instances_per_wave": 4})):
        m = json.loads((b / "traffic" / f"{src}.json").read_text())
        m["params"] = params
        (b / "traffic" / f"{mix}.json").write_text(json.dumps(m))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_l4", "source": "a test size",
                           "file": "benchmark/configs/tiny_l4.json",
                           "reduced": ["ell", "n"], "why": "tests"})
    for cell, mix in TINY_CELLS.items():
        man["workloads"].append({"name": cell, "config": "tiny_l4",
                                 "traffic": mix, "chips": 1, "why": "tests"})
    suffix = {"tiny_l4.sync": "verify", "tiny_l4.relay": "prove"}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" not in m:
            continue
        for cell, kind in suffix.items():
            if m["name"] == "import_s" or kind in m["name"]:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    add_tiny(root)
    return root


CPU_MAIN = """
import pathlib, sys
root = pathlib.Path.cwd()
sys.path[:0] = [str(root / "benchmark"), str(root)]
import torch
torch.set_num_threads(2)
from harness.core import main
sys.exit(main(sys.argv[1:], root=root, device="cpu"))
"""


def run_cpu(root: pathlib.Path, *args: str, timeout: float = 600,
            prelude: str = "") -> tuple[int, dict | None, str]:
    """The root's harness in a process of its own, on the CPU (the look
    for a card skipped): (exit code, result line or None, stderr)."""
    proc = subprocess.run(
        [sys.executable, "-c", prelude + CPU_MAIN, *args], cwd=root,
        capture_output=True, text=True, timeout=timeout,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc.returncode, (json.loads(lines[-1]) if lines else None), \
        proc.stderr


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: requires a CUDA device (runs a cell on the card)")
