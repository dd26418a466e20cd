"""The tune table the port ships (`curdleproofs_tpu_torch/ops/msm_tune.json`,
made on an H100 by two passes of `tools/msm_autotune.py`): it parses, holds
only `"cuda"` entries beside its stamp, every entry has the autotuner's
fields with a window width the device MSM supports and the shape family
`pick_params` gives that width, no entry is pending and every loser is
slower than its winner.  It changes nothing on the CPU: a CPU run reads an
empty table, splits a streamed batch 50/50 and keeps the untuned window
widths.  Nothing touches a card."""

import json
import pathlib
import re
import shutil

import pytest
import torch

from curdleproofs_tpu_torch.ops import msm_tune
from curdleproofs_tpu_torch.ops.backend import HybridBackend
from curdleproofs_tpu_torch.ops.msm_device import pick_params
from curdleproofs_tpu_torch.parallel import batch_verify as bv

torch.set_num_threads(1)

SHIPPED = pathlib.Path(msm_tune.__file__).with_name("msm_tune.json")
LOGNS = (7, 8, 9, 10, 12, 14, 16, 18, 20)
FAMILIES = [1 << k for k in LOGNS]
FIELDS = {"c", "t_rows", "s_pad", "device_warm_ms", "fresh_prep_ms",
          "fresh_prep_host_ms", "ingest_dev_ms", "host_ms", "losers",
          "host_ms_history"}


@pytest.fixture(autouse=True)
def _shipped(monkeypatch):
    monkeypatch.delenv("CURDLEPROOFS_TUNE", raising=False)
    msm_tune._load_raw.cache_clear()
    yield
    msm_tune._load_raw.cache_clear()


@pytest.fixture(scope="module")
def raw():
    return json.loads(SHIPPED.read_text())


def test_shipped_table_has_one_platform_and_a_stamp(raw):
    assert msm_tune.table_path() == SHIPPED
    assert set(raw) == {"cuda", msm_tune.STAMP_KEY}
    assert sorted(int(n) for n in raw["cuda"]) == FAMILIES
    stamp = msm_tune.table_stamp()
    assert stamp == raw[msm_tune.STAMP_KEY]
    assert re.fullmatch(r"NVIDIA H100.*, \d+\.\d+ W", stamp["card"])
    assert re.fullmatch(r"[0-9a-f]{40}", stamp["commit"])
    assert re.fullmatch(r"[0-9a-f]{64}", stamp["source_sha256"])
    assert re.fullmatch(r"\d{4}-\d\d-\d\dT[\d:]+\+00:00", stamp["date"])
    assert "cu" in stamp["torch"]
    assert stamp["logns"] == list(LOGNS) and stamp["quarantined"] == []


@pytest.mark.parametrize("n", FAMILIES)
def test_shipped_entry(raw, n):
    e = raw["cuda"][str(n)]
    assert FIELDS <= set(e) and "pending" not in e
    assert e["c"] in (8, 16)
    p = pick_params(n, e["c"], "cpu")
    assert (p.n, e["t_rows"], e["s_pad"]) == (n, p.t_rows, p.s_pad)
    assert min(e[k] for k in ("device_warm_ms", "fresh_prep_ms",
                              "host_ms")) > 0
    assert 0 < e["fresh_prep_host_ms"] <= e["fresh_prep_ms"]
    assert e["ingest_dev_ms"] >= 0
    # the autotuner tries c = 16 from 2^16 up; every loser is slower
    assert set(e["losers"]) == ({"8", "16"} - {str(e["c"])}
                                if n >= 1 << 16 else set())
    assert all(ms > e["device_warm_ms"] for ms in e["losers"].values())
    # two passes, both accepted by the contention guard
    hist = e["host_ms_history"]
    assert len(hist) >= 2 and hist[-1] == e["host_ms"]
    assert all(msm_tune._agrees(a, b) for a, b in zip(hist, hist[1:]))


def test_shipped_table_is_the_cards_only():
    """The card reads every family; the CPU reads nothing, so the CPU
    tests' split, window widths and routing stay the untuned ones."""
    assert sorted(msm_tune.load_table("cuda")) == FAMILIES
    assert msm_tune.load_table("cpu") == {}
    assert bv.plan_split_fraction(device="cpu") == 0.5
    for n in FAMILIES:
        assert pick_params(n).c == msm_tune.tuned_c(n)
        assert msm_tune.tuned_c(n, "cpu") is None
        assert pick_params(n, device="cpu").c == (8 if n < 1 << 19 else 16)
        assert msm_tune.route_to_device(n, True, "cpu") is None
    assert HybridBackend(device="cpu")._wants_device([None] * 1024) is False


def test_updates_keep_the_stamp(tmp_path, monkeypatch):
    """`record_entry` keeps the stamp and the other families; a new stamp
    keeps every entry; readers take only the device type's key."""
    path = tmp_path / "msm_tune.json"
    shutil.copy(SHIPPED, path)
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(path))
    msm_tune._load_raw.cache_clear()
    stamp = msm_tune.table_stamp()
    msm_tune.record_entry(1 << 11, {"c": 8, "device_warm_ms": 1.0,
                                    "fresh_prep_ms": 1.0, "host_ms": 2.0})
    assert msm_tune.table_stamp() == stamp
    assert sorted(msm_tune.load_table()) == sorted(FAMILIES + [1 << 11])
    msm_tune.record_stamp({"card": "x"})
    assert msm_tune.table_stamp() == {"card": "x"}
    assert sorted(msm_tune.load_table()) == sorted(FAMILIES + [1 << 11])
    assert msm_tune.load_table("cpu") == {}
    assert set(json.loads(path.read_text())) == {"cuda", msm_tune.STAMP_KEY}


def test_stamp_commit_outside_a_checkout(tmp_path, monkeypatch):
    """In a copy without `.git` (as on the machine with the card) the
    stamp's commit is `$CURDLEPROOFS_COMMIT`, else "unknown"."""
    from curdleproofs_tpu_torch.tools import common

    monkeypatch.setattr(common, "REPO", tmp_path)
    monkeypatch.delenv("CURDLEPROOFS_COMMIT", raising=False)
    assert common._commit() == "unknown"
    monkeypatch.setenv("CURDLEPROOFS_COMMIT", "f" * 40)
    assert common._commit() == "f" * 40
