"""The port's artifact downgrade guard (curdleproofs_tpu_torch/utils/
artifacts.py), held to the six tests of tests/test_artifact_guard.py: a
refresh must never silently replace a measurement artifact with a
smaller-scale or schema-poorer one."""

import json

import pytest

from curdleproofs_tpu_torch.utils.artifacts import (
    DOWNGRADE_ENV, ArtifactDowngrade, write_artifact,
)

RICH = {"ok": True, "world": 2, "batch": 1024, "ell": 252,
        "efficiency_isolated": 1.059}
SMOKE = {"ok": True, "world": 2, "batch": 4, "ell": 28}


def test_fresh_write_and_upgrade(tmp_path):
    p = tmp_path / "a.json"
    write_artifact(p, SMOKE)
    assert json.loads(p.read_text())["batch"] == 4
    write_artifact(p, RICH)  # larger scale replaces freely
    assert json.loads(p.read_text())["batch"] == 1024


def test_exact_r04_clobber_rejected(tmp_path):
    """The r04 incident: a B=4/ell=28 smoke run replacing B=1024/ell=252."""
    p = tmp_path / "bench_multihost.json"
    write_artifact(p, RICH)
    with pytest.raises(ArtifactDowngrade, match="batch: 1024 -> 4"):
        write_artifact(p, SMOKE)
    assert json.loads(p.read_text())["batch"] == 1024  # untouched


def test_schema_drop_rejected(tmp_path):
    p = tmp_path / "a.json"
    write_artifact(p, RICH)
    poorer = {k: v for k, v in RICH.items() if k != "efficiency_isolated"}
    with pytest.raises(ArtifactDowngrade, match="schema keys dropped"):
        write_artifact(p, poorer)


def test_equal_scale_refresh_allowed(tmp_path):
    p = tmp_path / "a.json"
    write_artifact(p, RICH)
    refreshed = dict(RICH, efficiency_isolated=0.97, extra_probe=1.0)
    write_artifact(p, refreshed)  # same scale, richer schema: fine
    assert json.loads(p.read_text())["efficiency_isolated"] == 0.97


def test_explicit_downgrade_flag(tmp_path, monkeypatch):
    p = tmp_path / "a.json"
    write_artifact(p, RICH)
    write_artifact(p, SMOKE, allow_downgrade=True)
    assert json.loads(p.read_text())["batch"] == 4
    write_artifact(p, RICH)
    monkeypatch.setenv(DOWNGRADE_ENV, "1")
    write_artifact(p, SMOKE)
    assert json.loads(p.read_text())["batch"] == 4


def test_corrupt_existing_is_replaced(tmp_path):
    p = tmp_path / "a.json"
    p.write_text("{truncated")
    write_artifact(p, SMOKE)  # unparseable old file cannot block progress
    assert json.loads(p.read_text())["batch"] == 4
