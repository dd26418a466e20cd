"""The port's measured MSM parameter table (`ops/msm_tune.py`): persistence,
window selection and routing crossovers, the seven tests of
`tests/test_msm_tune.py` against the port, each table keyed by a device's
type (here the `"cuda"` and `"cpu"` entries; nothing touches a card).  And
a table that holds only a `"tpu"` entry, the JAX package's key, routes
nothing and leaves `pick_params` alone."""

import json

import pytest
import torch

from curdleproofs_tpu_torch.ops import msm_tune
from curdleproofs_tpu_torch.ops.backend import HybridBackend
from curdleproofs_tpu_torch.ops.msm_device import pad_n, pick_params

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_cache():
    msm_tune._load_raw.cache_clear()
    yield
    msm_tune._load_raw.cache_clear()


def _with_table(tmp_path, monkeypatch, entries, key="cuda"):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({key: entries}))
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(path))
    msm_tune._load_raw.cache_clear()
    return path


def test_tuned_c_feeds_pick_params(tmp_path, monkeypatch):
    n = pad_n(1 << 17)
    _with_table(tmp_path, monkeypatch, {
        str(n): {"c": 16, "device_warm_ms": 1.0, "fresh_prep_ms": 1.0,
                 "host_ms": 9.0}})
    assert msm_tune.tuned_c(n) == 16
    assert pick_params(1 << 17).c == 16
    # untuned family falls back to the static heuristic
    assert pick_params(1 << 10).c == 8
    # the entry is the card's: a CPU run keeps the untuned switch
    assert msm_tune.tuned_c(n, "cpu") is None
    assert pick_params(1 << 17, device="cpu").c == 8


def test_route_to_device_crossovers(tmp_path, monkeypatch):
    _with_table(tmp_path, monkeypatch, {
        "65536": {"c": 8, "device_warm_ms": 300.0, "fresh_prep_ms": 500.0,
                  "host_ms": 650.0},
        "1024": {"c": 8, "device_warm_ms": 34.0, "fresh_prep_ms": 40.0,
                 "host_ms": 8.0}})
    # resident 2^16: 300 < 650 -> device
    assert msm_tune.route_to_device(65536, resident=True) is True
    # fresh 2^16: 300 + 500 > 650 -> host
    assert msm_tune.route_to_device(65536, resident=False) is False
    # small: host wins either way
    assert msm_tune.route_to_device(1024, resident=True) is False
    # nearest-family scaling: 2^15 resolves against the 2^16 entry
    assert msm_tune.route_to_device(32768, resident=True) is True
    # the table holds the card's entries only
    assert msm_tune.route_to_device(65536, True, "cpu") is None


def test_untuned_returns_none(tmp_path, monkeypatch):
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(tmp_path / "absent.json"))
    msm_tune._load_raw.cache_clear()
    assert msm_tune.route_to_device(65536, resident=True) is None
    assert msm_tune.tuned_c(65536) is None


def test_contention_guard_quarantines_outlier(tmp_path, monkeypatch):
    """A recorded host_ms of 359.1, then a contended pass measuring 964.4
    (2.7x): the guard must NOT let it overwrite the live fields."""
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(tmp_path / "g.json"))
    good = {"c": 8, "device_warm_ms": 319.7, "fresh_prep_ms": 257.1,
            "host_ms": 359.1}
    assert msm_tune.record_entry(65536, good) == "written"
    bad = {"c": 8, "device_warm_ms": 330.0, "fresh_prep_ms": 260.0,
           "host_ms": 964.4}
    assert msm_tune.record_entry(65536, bad) == "quarantined"
    table = msm_tune.load_table()
    assert table[65536]["host_ms"] == 359.1          # live value intact
    assert table[65536]["pending"]["host_ms"] == 964.4
    # a pass agreeing with the recorded value writes
    ok2 = dict(good, host_ms=370.0)
    assert msm_tune.record_entry(65536, ok2) == "written"
    assert msm_tune.load_table()[65536]["host_ms"] == 370.0


def test_contention_guard_two_agreeing_passes_overwrite(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(tmp_path / "g2.json"))
    msm_tune.record_entry(65536, {"c": 8, "device_warm_ms": 300.0,
                                  "fresh_prep_ms": 250.0, "host_ms": 359.1})
    slow = {"c": 8, "device_warm_ms": 300.0, "fresh_prep_ms": 250.0,
            "host_ms": 950.0}
    assert msm_tune.record_entry(65536, slow) == "quarantined"
    slow2 = dict(slow, host_ms=980.0)
    assert msm_tune.record_entry(65536, slow2) == "written"
    entry = msm_tune.load_table()[65536]
    assert entry["host_ms"] == 980.0                # the platform really moved
    assert 359.1 in entry["host_ms_history"]        # spread preserved


def test_contention_guard_force_overrides(tmp_path, monkeypatch):
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(tmp_path / "g3.json"))
    msm_tune.record_entry(1024, {"c": 8, "device_warm_ms": 40.0,
                                 "fresh_prep_ms": 60.0, "host_ms": 17.0})
    outlier = {"c": 8, "device_warm_ms": 40.0, "fresh_prep_ms": 60.0,
               "host_ms": 170.0}
    assert msm_tune.record_entry(1024, outlier, force=True) == "written"
    assert msm_tune.load_table()[1024]["host_ms"] == 170.0


def test_record_entry_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "rw.json"
    monkeypatch.setenv("CURDLEPROOFS_TUNE", str(path))
    msm_tune.record_entry(2048, {"c": 8, "device_warm_ms": 5.0,
                                 "fresh_prep_ms": 6.0, "host_ms": 7.0})
    assert msm_tune.load_table()[2048]["host_ms"] == 7.0
    # a second write merges, not clobbers; another device type's entry
    # lands under its own key
    msm_tune.record_entry(4096, {"c": 16, "device_warm_ms": 1.0,
                                 "fresh_prep_ms": 1.0, "host_ms": 9.0})
    msm_tune.record_entry(4096, {"c": 8, "device_warm_ms": 2.0,
                                 "fresh_prep_ms": 2.0, "host_ms": 3.0},
                          device="cpu")
    assert set(msm_tune.load_table()) == {2048, 4096}
    assert set(msm_tune.load_table("cpu")) == {4096}
    assert set(json.loads(path.read_text())) == {"cuda", "cpu"}


def test_tpu_entries_route_no_port_work(tmp_path, monkeypatch):
    """The JAX package's table is keyed "tpu": read by the port it routes
    nothing, picks no c, and HybridBackend keeps the untuned fallback."""
    n = pad_n(1 << 17)
    _with_table(tmp_path, monkeypatch, {
        str(n): {"c": 16, "device_warm_ms": 1.0, "fresh_prep_ms": 1.0,
                 "host_ms": 900.0},
        "1024": {"c": 8, "device_warm_ms": 0.1, "fresh_prep_ms": 0.1,
                 "host_ms": 900.0}}, key="tpu")
    for device in ("cuda", "cpu"):
        assert msm_tune.load_table(device) == {}
        assert msm_tune.tuned_c(n, device) is None
        assert msm_tune.route_to_device(1024, True, device) is None
        assert pick_params(1 << 17, device=device).c == 8
    hb = HybridBackend(device="cpu")
    assert hb._wants_device([None] * 1024) is False
