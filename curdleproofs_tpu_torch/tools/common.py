"""What every measurement tool shares: its arguments, its device, its clock,
and its artifact's stamps.

Each tool runs on the card unless given `--device cpu`, writes only to
`--out` (through `utils.artifacts.write_artifact`, which refuses to replace
a larger run with a smaller one), and stamps its artifact with the commit
(outside a checkout `$CURDLEPROOFS_COMMIT`, else `"unknown"`), a sha256 of
the port's `.py` and `csrc/` sources, the torch version and the card as
`nvidia-smi` names it (on the CPU: that there is none).  Tools run by their path or as modules
(`python -m curdleproofs_tpu_torch.tools.<name>`).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pathlib
import subprocess
import time

import torch

__all__ = ["IMAD_PER_CLK_PER_SM", "MUL32_PER_FQ_MUL", "PKG", "REPO", "Clock",
           "card_line", "device_of", "graph_ms", "int_rate", "parser",
           "source_sha256", "stamps", "sync", "write"]

PKG = pathlib.Path(__file__).resolve().parents[1]
REPO = PKG.parent
IMAD_PER_CLK_PER_SM = 64   # 32-bit integer multiply-add, compute capability 9.0
MUL32_PER_FQ_MUL = 600     # 300 32x32->64 products (CIOS, 12 limbs), 2 each


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the tools' two common options."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: raises without a card) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--out", type=pathlib.Path, required=True,
                    help="the JSON artifact to write (and only that)")
    return ap


def device_of(args) -> torch.device:
    """`--device`, raising for `cuda` when no card is present."""
    from curdleproofs_tpu_torch.ops.device import resolve_device

    return resolve_device(args.device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Marks of a run on `device`: CUDA events on a card (device time),
    the host clock on the CPU, where the plain versions run eagerly.
    `mark(stage)` is what the pipelines' `mark=` takes; `stages()` the ms
    from each mark to the next, under the later mark's name, after a
    synchronize."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: list[tuple[str, object]] = []

    def mark(self, stage: str) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((stage, ev))
        else:
            self.marks.append((stage, time.perf_counter()))

    def stages(self) -> dict[str, float]:
        sync(self.device)
        out: dict[str, float] = {}
        for (_, a), (s, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.device.type == "cuda" \
                else (b - a) * 1e3
            out[s] = out.get(s, 0.0) + ms
        return out


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`'s first line (raises if
    it fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def int_rate(device=None) -> float:
    """The card's 32-bit integer multiplies a second, the bound the kernels
    are read against: SMs x IMAD_PER_CLK_PER_SM x the SM's maximum clock
    (`nvidia-smi`)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    clock_hz = float(out.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * IMAD_PER_CLK_PER_SM * clock_hz


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device ms a call of `fn` without host gaps: `per_graph` calls
    captured in one CUDA graph, replayed `replays` times between two events
    (after one untimed replay).  The kernels' wrappers count their launches
    once, at capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def source_sha256() -> str:
    """sha256 over the port's `.py` files and `csrc/`, by relative path."""
    files = [p for p in PKG.rglob("*") if p.is_file()
             and (p.suffix == ".py" or p.parent.name == "csrc")
             and "_build" not in p.parts and "__pycache__" not in p.parts]
    h = hashlib.sha256()
    for p in sorted(files):
        h.update(str(p.relative_to(PKG)).encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest()


def _commit() -> str:
    """HEAD of the checkout this tree is the root of; outside one (a copy
    without `.git`), `$CURDLEPROOFS_COMMIT` as the caller names it, else
    "unknown"."""
    fallback = os.environ.get("CURDLEPROOFS_COMMIT", "unknown")
    try:
        r = subprocess.run(["git", "-C", str(REPO), "rev-parse",
                            "--show-toplevel", "HEAD"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return fallback
    lines = r.stdout.split()
    if r.returncode or len(lines) != 2 \
            or pathlib.Path(lines[0]).resolve() != REPO.resolve():
        return fallback
    return lines[1]


def stamps(device: torch.device) -> dict:
    return {"commit": _commit(), "source_sha256": source_sha256(),
            "torch": torch.__version__,
            "card": card_line() if device.type == "cuda" else "none (cpu run)",
            "device": str(device)}


def write(out: pathlib.Path, artifact: dict, device: torch.device) -> dict:
    """`artifact` with its `stamps`, written to `out`; returns it."""
    from curdleproofs_tpu_torch.utils.artifacts import write_artifact

    art = {**artifact, "stamps": stamps(device)}
    out.parent.mkdir(parents=True, exist_ok=True)
    write_artifact(out, art)
    return art
