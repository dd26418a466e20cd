"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration (`benchmark/configs/`), its mix
(`benchmark/traffic/`, read by `traffic.py`), the entry that drives the
program (`benchmark/entries/<mix's entry>.py`) and each metric's reader
(`benchmark/metrics/<metric>.py`) are found by name.  A run: the
reference's process starts and makes the inputs from the seed
(`refproc.py`), while this process, pinned to half of the cores, imports
the program, checks for the card and loads the kernels;
then the inputs in the program's types, one warm-up call of each kind of
work, and the closed loop (one client, calls back to back) for
`--seconds`; then the reference's process judges the program's outputs,
the check that no JAX module loaded, and the result line.

Two options serve the controls and tests, never the cells' own runs:
`--control` puts the reference, with one of the configuration's
guarantees broken, in the program's place; `--fault <name>` breaks the
timed path underneath in one of the entry's named ways.  Both must come
out not correct.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import hygiene, manifest, traffic
from .refproc import RefProcess
from .trace import Spans, read_trace

CACHE = ("benchmark", "_cache")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_module(path: pathlib.Path, name: str):
    """A module from its file (entry and reader names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What an entry gets: the configuration as run, the mix's
    parameters, the seed, the device, the spans and the counters."""
    root: pathlib.Path
    cfg: dict
    params: dict
    seed: int
    device: str
    traced: bool
    spans: Spans
    kinds: tuple = ()
    counters: dict = field(default_factory=dict)


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: dict
    setup: dict
    setup_s: float
    window_s: float
    units: int
    calls: int
    spans: Spans
    counters: dict
    trace: object = None
    int_rate: float | None = None


def set_env(root: pathlib.Path, mix: dict) -> None:
    """Caches inside the checkout at fixed paths; the program's defaults
    (no knob of its own set); what the mix turns off."""
    cache = root.joinpath(*CACHE)
    for var, sub in (("CURDLEPROOFS_AOT_DIR", "aot"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    for var in [v for v in os.environ if v.startswith("CURDLEPROOFS_")
                and v != "CURDLEPROOFS_AOT_DIR"]:
        del os.environ[var]
    os.environ.pop("CP_NO_DECOMPRESS_CACHE", None)
    os.environ["USE_FLAX"] = "0"
    for var, value in mix.get("env", {}).items():
        os.environ[var] = value


def split_cores() -> tuple[list[int], list[int]]:
    """The cores of this process (the first half of the ones it may use)
    and of the reference's (all but the first: it makes the inputs while
    this process imports, and it is idle while the window runs)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        return cores, cores
    return cores[: len(cores) // 2], cores[1:]


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    return ap.parse_args(argv)


def main(argv=None, root: pathlib.Path | None = None, device: str | None = None,
         t_start: float | None = None) -> int:
    """Run one cell once; returns the exit code.  `device="cpu"` (tests)
    skips the look for a card, runs the program's CPU versions, pins no
    core and gives the reference's process no workers."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = root or pathlib.Path(__file__).resolve().parents[2]
    man = manifest.load(root)
    cell = manifest.workload(man, args.workload)
    cfg = json.loads((root / manifest.config(man, cell["config"])["file"])
                     .read_text())
    mix = traffic.load_mix(root, cell["traffic"])
    traced = bool(args.trace)
    set_env(root, mix)
    kinds = tuple(sorted(mix["period"]))
    mine, theirs = split_cores() if device is None else ([], [])
    if mine:
        os.sched_setaffinity(0, mine)
    ref = RefProcess(root, mix["entry"], cfg, mix["params"], args.seed, kinds,
                     theirs)
    try:
        return _run(args, root, man, cell, cfg, mix, traced, kinds, ref,
                    device, t_start)
    finally:
        ref.close()


def _run(args, root, man, cell, cfg, mix, traced, kinds, ref, device,
         t_start) -> int:
    setup: dict[str, float] = {}

    # the program's import (torch's with it), then the device check, then
    # the first load of its kernels
    t = time.perf_counter()
    import torch

    setup["torch_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    import curdleproofs_tpu_torch  # noqa: F401
    from curdleproofs_tpu_torch.ops import kernels

    entry = load_module(root / "benchmark" / "entries" / f"{mix['entry']}.py",
                        f"bench_entry_{mix['entry']}")
    setup["program_import_s"] = time.perf_counter() - t
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA device: this benchmark measures the card")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            log(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell['chips']}")
            return 2
        device = "cuda"
    t = time.perf_counter()
    if device == "cuda":
        with kernels.launches_into({}):
            kernels.warm_entries("cuda")
        torch.cuda.synchronize()
    setup["kernel_load_s"] = time.perf_counter() - t
    setup["import_s"] = (setup["torch_import_s"] + setup["program_import_s"]
                         + setup["kernel_load_s"])

    spans = Spans(traced)
    ctx = Context(root, cfg, mix["params"], args.seed, device, traced, spans,
                  kinds)
    t = time.perf_counter()
    data = ref.inputs()
    setup["inputs_wait_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state = entry.setup(ctx, data)
    del data
    setup["inputs_s"] = time.perf_counter() - t
    call = entry.run_control if args.control else entry.run
    if args.fault is not None:
        call = entry.FAULTS[args.fault](call)
    entry.instrument(state)
    # every kind of work runs the same shapes: one call warms them all
    t = time.perf_counter()
    call(state, kinds[0])
    if device == "cuda":
        torch.cuda.synchronize()
    setup["warmup_s"] = time.perf_counter() - t

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    order = traffic.sequence(mix, args.seed)
    done, attempted, failed, first_error = [], 0, 0, None
    launches0 = dict(kernels.LAUNCHES)
    spans.enabled = True
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    with spans.span("window"):
        while True:
            kind = next(order)
            units = entry.units(state, kind)
            attempted += units
            try:
                with spans.span(entry.CALL_SPAN):
                    out = call(state, kind)
                done.append((kind, out))
            except Exception:  # the loop's boundary: count, keep the first
                failed += units
                first_error = first_error or traceback.format_exc()
            if time.perf_counter() - w0 >= args.seconds:
                break
    window_s = time.perf_counter() - w0
    spans.enabled = False
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = root.joinpath(*CACHE) / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        trace = read_trace(path)
        path.unlink()
    peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    launches = {k: v - launches0.get(k, 0) for k, v in kernels.LAUNCHES.items()
                if v != launches0.get(k, 0)}
    if first_error:
        log("a call in the window raised:\n" + first_error)

    log("setup split, s: " + json.dumps(setup))
    log("call walls, s: " + json.dumps(
        [t1 - t0 for n, t0, t1 in spans.records if n == entry.CALL_SPAN]))
    log("span totals, s: " + json.dumps(
        {n: spans.total(n) for n in sorted({r[0] for r in spans.records})}))
    log(f"window: {len(done)} calls completed, {attempted} proofs attempted, "
        f"{failed} failed, {window_s:.4f} s; kernel launches "
        + json.dumps(launches))
    for line in entry.report(state):
        log(line)

    run = Run(cell, setup, setup_s, window_s,
              sum(entry.units(state, k) for k, _ in done), len(done), spans,
              ctx.counters, trace)
    if traced and device == "cuda":
        from .yardstick import int_rate

        run.int_rate = int_rate()
    metrics = {}
    for m in manifest.metrics_for(man, cell["name"], traced):
        reader = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                             f"bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs
    entry.release(state)
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = ref.judge(entry.outputs(state, done))
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s")
    checks["failed_calls"] = (failed, 0)
    correct = bool(done) and all(v <= lim for v, lim in checks.values())

    found = hygiene.forbidden_modules()
    if found:
        log("modules of JAX or of the JAX package loaded: " + ", ".join(found))
        return 3
    found = hygiene.reference_modules()
    if found and not args.control:
        log("the reference loaded in the timed process: " + ", ".join(found))
        return 3

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        if trace is not None:
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.window_s
            result["breakdown"] = trace.breakdown()
        else:
            log("the trace holds no device operation inside the window")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
