"""The measurement tools (curdleproofs_tpu_torch/tools/) on the CPU at tiny
sizes: each runs with `--device cpu`, writes its artifact, and only that,
under `--out`, with its stamps, and checks its results against the native
host; without `--device cpu` each raises on a machine without a card.
`msm_profile`'s stage map covers every stage the pipeline marks.

On the CPU the kernels' plain versions run, so every time here is the host
clock on plain arithmetic: no device number."""

import inspect
import json
import re

import pytest
import torch

from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.tools import (
    aot_export, batch_prove_bench, cold_start_probe, grouped_profile,
    msm_profile, msm_sweep, multihost_scaling, scaling_report, speed_of_light,
    sync_floor_probe,
)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

TOOLS = [aot_export, batch_prove_bench, cold_start_probe, grouped_profile,
         msm_profile, msm_sweep, multihost_scaling, scaling_report,
         speed_of_light, sync_floor_probe]


def run(tool, argv, tmp_path, monkeypatch) -> dict:
    """`tool.main(argv)` on the CPU from an empty working directory; the
    artifact, after checking that nothing but it was written and that its
    stamps are there."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = tmp_path / "out" / "artifact.json"
    assert tool.main([*argv, "--device", "cpu", "--out", str(out)]) == 0
    assert list(cwd.iterdir()) == []
    assert [p.name for p in out.parent.iterdir()] == ["artifact.json"]
    art = json.loads(out.read_text())
    st = art["stamps"]
    assert re.fullmatch(r"[0-9a-f]{40}|unknown", st["commit"])
    assert re.fullmatch(r"[0-9a-f]{64}", st["source_sha256"])
    assert st["torch"] == torch.__version__
    assert st["card"] == "none (cpu run)" and st["device"] == "cpu"
    assert art["match"] is True
    return art


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".")[-1])
def test_tool_needs_a_card_unless_asked(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "a.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--out", str(out)])
    assert not out.exists()


def test_cold_start_probe(tmp_path, monkeypatch):
    monkeypatch.delenv("CURDLEPROOFS_BG_INIT", raising=False)
    art = run(cold_start_probe, ["6"], tmp_path, monkeypatch)
    assert art["aot_hit"] is None and art["built_s"] == 0   # no library
    phases = ["import_s", "init_s", "native_s", "host_gen_s",
              "first_device_touch_s", "upload_s", "first_msm_s",
              "second_msm_s", "total_cold_s"]
    assert all(art[k] >= 0 for k in phases)
    assert "bg_init" not in art


def test_cold_start_probe_background_init(tmp_path, monkeypatch):
    from curdleproofs_tpu_torch.ops import warmup

    monkeypatch.setattr(warmup, "_thread", None)
    monkeypatch.setattr(warmup, "_result", {})
    monkeypatch.setenv("CURDLEPROOFS_BG_INIT", "1")
    art = run(cold_start_probe, ["6"], tmp_path, monkeypatch)
    # no card: the warm-up records why, and the CPU run goes on
    assert "no CUDA device" in art["bg_init"]["error"]


def test_sync_floor_probe(tmp_path, monkeypatch):
    art = run(sync_floor_probe, ["--ell", "4"], tmp_path, monkeypatch)
    assert art["serial_challenge_syncs"] == 2 * 3 + 3      # n = 8
    assert art["prover_device_floor_ms"] == pytest.approx(
        art["serial_challenge_syncs"] * art["sync_floor_ms"])
    assert art["host_prove_ms"] > 0


def test_msm_profile_and_its_stage_map(tmp_path, monkeypatch):
    art = run(msm_profile, ["6", "--reps", "1"], tmp_path, monkeypatch)
    marked = set()
    for fn in (md._pipeline_core, md._msm_pipeline):
        marked |= set(re.findall(r'mark\("(\w+)"\)', inspect.getsource(fn)))
    assert marked == {"upload", "recode", "plan", "fold", "merge", "dense",
                      "suffix", "reduce", "leave_mont"}
    assert marked == set(msm_profile.STAGE_MAP)
    assert set(art["stage_map"]) == marked
    reference = {"digits", "sort", "plan", "gather", "fold", "merge", "full"}
    assert set().union(*msm_profile.STAGE_MAP.values()) == reference
    row = art["results"]["6"]
    assert set(row["stage_ms"]) == marked               # every stage timed
    assert row["n"] == 64 and row["c"] == 8


def test_grouped_profile(tmp_path, monkeypatch):
    art = run(grouped_profile, ["8", "4", "--bases", "64", "--reps", "1"],
              tmp_path, monkeypatch)
    slot, table = art["modes"]["slot"], art["modes"]["table"]
    assert set(slot["stage_ms"]) == {"upload", "recode", "plan", "fold",
                                     "merge", "suffix", "horner"}
    assert set(table["stage_ms"]) == {"upload", "recode", "plan", "fold",
                                      "horner"}
    assert slot["match"] and table["match"]


def test_batch_prove_bench(tmp_path, monkeypatch):
    art = run(batch_prove_bench, ["2", "4", "--no-warm"], tmp_path,
              monkeypatch)
    assert art["gates"] == {"bytes_match_sequential": True,
                            "verify_ok": True}
    assert art["B"] == 2 and art["warm_s"] is None
    assert art["phases"]["dispatches"] == 10


def test_speed_of_light(tmp_path, monkeypatch):
    art = run(speed_of_light, ["--logn", "6", "--chains", "2", "4",
                               "--trials", "1"], tmp_path, monkeypatch)
    assert art["fq_mul_ms"] > 0 and art["g1_add_ms"] > 0
    assert "fq_mul_pct_of_sol" not in art       # no device rate on the CPU


def test_scaling_report(tmp_path, monkeypatch):
    art = run(scaling_report, ["--n", "16", "--ds", "1", "2"], tmp_path,
              monkeypatch)
    assert [r["grid"] for r in art["rows"]] == [[1, 1], [2, 1]]
    assert [r["cell_points"] for r in art["rows"]] == [16, 8]


def test_multihost_scaling(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the two ranks too
    art = run(multihost_scaling, ["4", "4", "--rounds", "1"], tmp_path,
              monkeypatch)
    workers = art["live_world2"]["workers"]
    assert sorted(w["rank"] for w in workers) == [0, 1]
    assert all(w["global_ok"] and w["world"] == 2 for w in workers)
    assert [w["slice"] for w in sorted(workers, key=lambda w: w["rank"])] \
        == [[0, 2], [2, 4]]
    assert art["single_host"]["n"] == 4
