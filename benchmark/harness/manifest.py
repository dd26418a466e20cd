"""`BENCHMARK.json`: the cells, configurations and metrics, and the
character rules their names and units keep."""

from __future__ import annotations

import json
import pathlib
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def metrics_for(man: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or
    with tracing its per-layer ones."""
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"] if _applies(m, cell, names)]


def problems(man: dict) -> list[str]:
    """What in the manifest breaks the character and shape rules."""
    out = []

    def name_ok(kind, v):
        if not isinstance(v, str) or not NAME.match(v):
            out.append(f"{kind} name {v!r}")

    def line_ok(kind, v):
        if not isinstance(v, str) or not 1 <= len(v) <= 200 \
                or "\n" in v or "\t" in v:
            out.append(f"{kind} {v!r}")

    for c in man["configs"]:
        name_ok("config", c["name"])
        line_ok("source", c["source"])
        line_ok("why", c["why"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
    for w in man["workloads"]:
        for k in ("name", "config", "traffic"):
            name_ok(f"workload {k}", w[k])
        line_ok("why", w["why"])
        if w["chips"] not in (1, 4):
            out.append(f"chips {w['chips']}")
    for part, sources in (("end_to_end", SOURCES_E2E), ("per_layer", SOURCES)):
        for m in man[part]:
            name_ok("metric", m["name"])
            if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
                out.append(f"unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"better {m['better']!r}")
            if m["source"] not in sources:
                out.append(f"source {m['source']!r}")
            if part == "per_layer":
                line_ok("layer", m["layer"])
    for word in man["command"]:
        line_ok("command word", word)
    names = [m["name"] for p in ("end_to_end", "per_layer") for m in man[p]]
    for kind, seq in (("metric", names),
                      ("workload", [w["name"] for w in man["workloads"]]),
                      ("config", [c["name"] for c in man["configs"]])):
        if len(seq) != len(set(seq)):
            out.append(f"duplicate {kind} names")
    return out
