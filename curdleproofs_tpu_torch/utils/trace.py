"""The port's spans and counters: one in-memory recorder (the reference's
`print-trace` feature analog, `curdleproofs/Cargo.toml:36`).

`span(name, **attrs)` times one step of the program, and its attributes
count what the step worked on (`points=`, `terms=`, `relations=`);
`count(name, n)` adds to a counter where no span carries the number.
Recording is on while any of these holds:

- `CURDLEPROOFS_TRACE=1` was set when this module was imported (the
  operator's switch; a summary then goes to stderr at exit);
- `enable()` was called;
- a `torch.profiler` runs in this thread: each span then also opens a
  `record_function("cp/<name>")` range, so the exported Chrome trace
  carries the program's spans as `user_annotation` events on the same
  timeline as the kernels and copies.  A span opened once an item (a
  proof, a tracker list, a native MSM, a dispatch: tens to hundreds a
  call) passes `timeline=False` and records without a range: over a
  profiled window those ranges cost the host several percent;
- the innermost open span records: a span opened under it records too,
  also on a work thread that runs in its submitter's context
  (`contextvars.copy_context().run`).

Off, a span is one test and a shared no-op context manager, unless the
caller passes `acc=` and `key=`: those seconds are added to `acc[key]`
whether or not the span records.

A record (`Record`) holds the span's id, its parent's id (the innermost
span open in this context when it started), the call id (the id of the
root span, shared by every span of one top-level call), the name, start and
end from `time.perf_counter_ns()` (CLOCK_MONOTONIC on Linux), the thread id
and the span's attributes.  `records()`, `counters()` and `reset()` read
and clear the buffer; it holds at most `MAX_RECORDS` records, and the spans
beyond the bound are dropped and counted under `trace.dropped`.
"""

from __future__ import annotations

import atexit
import contextvars
import itertools
import os
import sys
import threading
import time
from typing import NamedTuple

__all__ = ["MAX_RECORDS", "Record", "attr_totals", "count", "counters",
           "enable", "records", "reset", "self_times", "span", "summary",
           "trace_enabled"]

MAX_RECORDS = 1 << 20


class Record(NamedTuple):
    id: int
    parent: int | None
    call: int
    name: str
    t0_ns: int
    t1_ns: int
    tid: int
    attrs: dict | None


_FROM_ENV = os.environ.get("CURDLEPROOFS_TRACE") == "1"
_on = _FROM_ENV
_records: list[Record] = []
_counters: dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_open: contextvars.ContextVar = contextvars.ContextVar(
    "curdleproofs_open_span", default=None)
_pe = None   # torch.autograd._profiler_enabled, once torch is loaded


def _no_profiler() -> bool:
    return False


def _profiler_check():
    """The test for a running `torch.profiler` in this thread: torch's own
    once torch is loaded (importing the protocol layer loads none), else a
    stand-in that says no (and the next call looks again)."""
    global _pe
    autograd = getattr(sys.modules.get("torch"), "autograd", None)
    if autograd is None:   # not loaded, or half imported
        return _no_profiler
    _pe = autograd._profiler_enabled
    return _pe


def trace_enabled() -> bool:
    """Whether a span opened here and now records."""
    return _on or _open.get() is not None or (_pe or _profiler_check())()


def enable(on: bool = True) -> None:
    """Turn recording on (or off again) for the whole process."""
    global _on
    _on = on


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class _Timed:
    """A span that does not record: only the caller's accumulator."""
    __slots__ = ("acc", "key", "t0")

    def __init__(self, acc: dict, key: str):
        self.acc, self.key = acc, key

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter_ns() - self.t0) * 1e-9
        self.acc[self.key] = self.acc.get(self.key, 0.0) + dt
        return False


class _Span:
    __slots__ = ("name", "acc", "key", "timeline", "attrs", "id", "parent",
                 "call", "token", "rf", "t0")

    def __init__(self, name, acc, key, timeline, attrs):
        self.name, self.acc, self.key = name, acc, key
        self.timeline, self.attrs = timeline, attrs

    def __enter__(self):
        outer = _open.get()
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.call = self.id if outer is None else outer.call
        self.token = _open.set(self)
        self.rf = None
        if self.timeline and (_pe or _profiler_check())():
            import torch

            self.rf = torch.profiler.record_function("cp/" + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.reset(self.token)
        if self.acc is not None:
            self.acc[self.key] = (self.acc.get(self.key, 0.0)
                                  + (t1 - self.t0) * 1e-9)
        rec = Record(self.id, self.parent, self.call, self.name, self.t0, t1,
                     threading.get_ident(), self.attrs)
        with _lock:
            if len(_records) < MAX_RECORDS:
                _records.append(rec)
            else:
                _counters["trace.dropped"] = _counters.get("trace.dropped",
                                                           0) + 1
        return False


def span(name: str, acc: dict | None = None, key: str | None = None,
         timeline: bool = True, **attrs):
    """A context manager that times the step `name` (see the module
    docstring); `attrs` go into its record.  With `acc` and `key`, the
    step's seconds are also added to `acc[key]`, recording or not.
    `timeline=False`: no profiler range for this span."""
    if not (_on or _open.get() is not None or (_pe or _profiler_check())()):
        return _OFF if acc is None else _Timed(acc, key)
    return _Span(name, acc, key, timeline, attrs or None)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`, while recording is on."""
    if _on or _open.get() is not None or (_pe or _profiler_check())():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def records() -> list[Record]:
    with _lock:
        return list(_records)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clear the records and the counters."""
    with _lock:
        _records.clear()
        _counters.clear()


def self_times(recs: list[Record]) -> dict[int, int]:
    """Each record's self time in ns: its duration less the part of it that
    its child spans cover (children on other threads may overlap)."""
    kids: dict[int, list[tuple[int, int]]] = {}
    for r in recs:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append((r.t0_ns, r.t1_ns))
    out = {}
    for r in recs:
        covered, end = 0, r.t0_ns
        for a, b in sorted(kids.get(r.id, ())):
            a, b = max(a, end), min(b, r.t1_ns)
            if b > a:
                covered += b - a
                end = b
        out[r.id] = r.t1_ns - r.t0_ns - covered
    return out


def attr_totals(recs: list[Record]) -> dict[str, int | float]:
    """The spans' numeric attributes summed per span name and attribute,
    keyed `<span name>.<attribute>`."""
    out: dict[str, int | float] = {}
    for r in recs:
        for k, v in (r.attrs or {}).items():
            if isinstance(v, (int, float)):
                key = f"{r.name}.{k}"
                out[key] = out.get(key, 0) + v
    return out


def summary(recs: list[Record] | None = None,
            ctrs: dict[str, int] | None = None) -> str:
    """Per span name the count, the total and the self time, then the
    spans' attribute totals and the counters."""
    recs = records() if recs is None else recs
    ctrs = counters() if ctrs is None else ctrs
    own = self_times(recs)
    rows: dict[str, list] = {}
    for r in recs:
        row = rows.setdefault(r.name, [0, 0, 0])
        row[0] += 1
        row[1] += r.t1_ns - r.t0_ns
        row[2] += own[r.id]
    lines = [f"{'span':<28} {'count':>8} {'total ms':>12} {'self ms':>12}"]
    for name, (n, tot, own_ns) in sorted(rows.items(),
                                         key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<28} {n:>8} {tot * 1e-6:>12.3f} "
                     f"{own_ns * 1e-6:>12.3f}")
    for name, v in sorted({**attr_totals(recs), **ctrs}.items()):
        lines.append(f"{name:<28} {v:>8}")
    return "\n".join(lines)


def _print_summary() -> None:
    if _records or _counters:
        print("[trace] curdleproofs_tpu_torch spans and counters\n"
              + summary(), file=sys.stderr)


if _FROM_ENV:
    atexit.register(_print_summary)
