"""BENCHMARK.json against the benchmark's contract: names, units, shapes,
and every configuration, mix, entry and metric found as a file by name."""

import json

from conftest import BENCH, ROOT
from harness import manifest, traffic


def _man():
    return manifest.load(ROOT)


def test_names_units_and_lines_keep_the_rules():
    assert manifest.problems(_man()) == []


def test_rule_checker_catches_breaches():
    man = _man()
    man["per_layer"][0]["name"] = "has space"
    man["end_to_end"][0]["unit"] = "tokens per second"
    man["workloads"][0]["why"] = "x" * 201
    found = manifest.problems(man)
    assert any("has space" in p for p in found)
    assert any("tokens per second" in p for p in found)
    assert any(p.startswith("why") for p in found)


def test_top_level_shape():
    man = _man()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}
    four = [w for w in man["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(man["workloads"]) // 4)


def test_every_piece_is_a_file_found_by_name():
    man = _man()
    for c in man["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.is_relative_to(BENCH)
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len({c["file"] for c in man["configs"]}) == len(man["configs"])
    assert {w["config"] for w in man["workloads"]} == \
        {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        mix = traffic.load_mix(ROOT, w["traffic"])
        assert (BENCH / "entries" / f"{mix['entry']}.py").is_file()
    for m in man["end_to_end"] + man["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    man = _man()
    e2e = {m["name"] for m in man["end_to_end"]}
    for w in man["workloads"]:
        mine = {m["name"] for m in manifest.metrics_for(man, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layers = manifest.metrics_for(man, w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in e2e and m["moves"] in mine


def test_layers_named_alike():
    man = _man()
    layers = {m["layer"] for m in man["per_layer"]}
    assert layers == {"process start", "protocol and batch", "MSM pipelines",
                      "kernels", "device"}


def test_traffic_period_is_the_same_multiset_in_a_seeded_order():
    mix = traffic.load_mix(ROOT, "sync_verify")
    size = sum(mix["period"].values())

    def first(seed, n):
        it = traffic.sequence(mix, seed)
        return [next(it) for _ in range(n)]

    a = first(2**31 + 5, 4 * size)
    assert a == first(2**31 + 5, 4 * size)
    assert a != first(2**31 + 6, 4 * size)
    for k in range(4):
        chunk = a[k * size:(k + 1) * size]
        assert {kind: chunk.count(kind) for kind in set(chunk)} == mix["period"]
