"""Spans from the benchmark's own files, and the reduction of a
`torch.profiler` trace to what the per-layer readers read.

`Spans` times each call the harness makes into a layer of the program on
the host clock; in a traced run each span is also a `record_function`
range named `bench/<name>`, so the trace's timeline carries it.
`read_trace` takes the exported Chrome trace: the device's operations
(kernels, copies, fills), their union inside the `bench/window` span, the
idle gaps between them, each named by the innermost harness span open at
the time, and device seconds by operation name.  The operations that the
harness's own `bench/probe` spans launch (their runtime calls share a
correlation id with them) are left out of all of it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import pathlib
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench/"


class Spans:
    """Host-clock spans (name, start, end); in a traced run also profiler
    ranges.  `enabled` gates the recording, so set-up calls through the
    same wrappers leave no span."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.enabled = False
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        ctx = contextlib.nullcontext()
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.records if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.records if n == name)


@dataclass
class Trace:
    window_s: float
    busy_s: float
    op_seconds: dict = field(default_factory=dict)   # short name -> s
    gaps: list = field(default_factory=list)         # [(span, s)], longest first

    def seconds_of(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(s for name, s in self.op_seconds.items()
                   if any(n in name for n in needles))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


def short_name(name: str, cap: int = 160) -> str:
    """A kernel's name without its return type and argument list (the
    first parenthesis outside template brackets that follows a name)."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] not in ": ":
            name = name[:i]
            break
    return name[:cap] or "unnamed"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(path: pathlib.Path) -> Trace | None:
    """Reduce an exported Chrome trace; None where it holds no window
    span or no device operation inside it."""
    events = json.loads(pathlib.Path(path).read_text()).get("traceEvents", [])
    spans, dev, launches = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((a, b, e["name"][len(PREFIX):]))
        elif cat in DEVICE_CATS:
            dev.append((a, b, short_name(e.get("name", cat)), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches.append((a, corr))
    probes = sorted((a, b) for a, b, n in spans if n == "probe")
    if probes:
        starts = [a for a, _ in probes]
        ours = set()
        for t, corr in launches:
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= probes[k][1]:
                ours.add(corr)
        dev = [d for d in dev if d[3] is None or d[3] not in ours]
    windows = [(a, b) for a, b, n in spans if n == "window"]
    if not windows:
        return None
    w0, w1 = windows[0]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n, _ in dev
              if b > w0 and a < w1]
    if not inside:
        return None
    ops: dict[str, float] = {}
    for a, b, n in inside:
        ops[n] = ops.get(n, 0.0) + (b - a) * 1e-6
    busy = _union((a, b) for a, b, _ in inside)
    gaps = []
    edges = [w0] + [x for seg in busy for x in seg] + [w1]
    inner = [(a, b, n) for a, b, n in spans if n not in ("window", "probe")]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [(sb - sa, n) for sa, sb, n in inner if sa <= mid < sb]
        gaps.append((min(open_)[1] if open_ else "harness", (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 op_seconds=ops, gaps=gaps)
