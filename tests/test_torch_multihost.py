"""World > 1 process-group execution in the port: drives
curdleproofs_tpu_torch/tools/multihost_verify.py, whose two processes join
a gloo process group on localhost (at a port the script finds free), each
verify their `process_slice` of a shared batch on the host backend, and
AND-reduce the verdict over `all_hosts_agree`.  The assertions are
tests/test_multihost.py's; the artifact goes to a temporary path."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = REPO / "curdleproofs_tpu_torch" / "tools" / "multihost_verify.py"


def test_two_process_distributed_batch_verify(tmp_path):
    out_path = tmp_path / "multihost.json"
    env = {**os.environ, "CURDLEPROOFS_BACKEND": "host",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--out", str(out_path)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    artifact = json.loads(out.stdout.splitlines()[-1])
    assert json.loads(out_path.read_text()) == artifact
    assert artifact["ok"] is True
    ranks = {w["rank"]: w for w in artifact["workers"]}
    assert all(w["process_count"] == 2 for w in ranks.values())
    assert all(w["backend"] == "host" for w in ranks.values())
    # the AND-reduction saw True/True -> True and True/False -> False
    assert ranks[0]["valid_pass"] and ranks[1]["valid_pass"]
    assert ranks[0]["local_ok_corrupt"] and not ranks[1]["local_ok_corrupt"]
    assert not ranks[0]["corrupt_pass"] and not ranks[1]["corrupt_pass"]


def test_script_needs_an_output_path():
    out = subprocess.run([sys.executable, str(SCRIPT)], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 2 and "--out is required" in out.stderr
