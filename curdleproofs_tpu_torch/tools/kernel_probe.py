"""Kernel measurements on one CUDA card, beyond what `chip_smoke.py` checks.

    python curdleproofs_tpu_torch/tools/kernel_probe.py trace [--tree DIR]
    python curdleproofs_tpu_torch/tools/kernel_probe.py suffix

`trace`: the l = 124 Whisk shuffle proof of `StdRng.seed_from_u64(0)` (the
golden 4496 bytes, checked) on the card, after one untimed warm-up prove:
one prove with every kernel launch between two CUDA events (ms summed by
wrapper; a span also holds the card's wait for the launch), then one under
`torch.profiler` (device ms summed by CUDA kernel name: every kernel of
the port, then torch's 15 costliest; the card's busy time against the
prove's wall).  `--tree` imports `curdleproofs_tpu_torch`
from another checkout (run this file by its path), so two trees are traced
with one script.

`suffix`: g1_suffix_weighted's chain and tree entries at Cb = 8 and 16 over
a sweep of WG, each timed with `graph_ms` in turns (chain, tree, tree,
chain): the crossover that `kernels.SUFFIX_TREE_MAX_WG` is set from.

Each prints one JSON line; `nvidia-smi`'s name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _prove_once(golden: str):
    from curdleproofs_tpu_torch.constants import WHISK_ELL
    from curdleproofs_tpu_torch.crs import CurdleproofsCrs
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.whisk import (
        WhiskTracker, generate_whisk_shuffle_proof,
    )

    rng = StdRng.seed_from_u64(0)
    crs = CurdleproofsCrs.generate_crs(WHISK_ELL)
    pre = [WhiskTracker.from_rand(rng) for _ in range(WHISK_ELL)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, proof = generate_whisk_shuffle_proof(rng, crs, pre)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if proof.hex() != golden:
        raise AssertionError("l=124 proof differs from the golden vector")
    return wall


def trace(tree: pathlib.Path) -> dict:
    from curdleproofs_tpu_torch.backend import use_backend
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.backend import TorchBackend

    golden = (tree / "tests" / "golden" /
              "whisk_shuffle_proof_128.hex").read_text().strip()
    K.build()
    spans = []
    launch = K._launch

    def timed(name, device, *args, entry=None):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        launch(name, device, *args, entry=entry)
        e.record()
        spans.append((name, s, e))

    with use_backend(TorchBackend()):
        warm_ms = _prove_once(golden)
        K._launch = timed
        try:
            events_wall = _prove_once(golden)
        finally:
            K._launch = launch
        by_wrapper: dict = {}
        for name, s, e in spans:
            n, ms = by_wrapper.get(name, (0, 0.0))
            by_wrapper[name] = (n + 1, ms + s.elapsed_time(e))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_wall = _prove_once(golden)
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            by_kernel[ev.key] = (ev.count, dev_us / 1e3)
    busy = sum(ms for _, ms in by_kernel.values())
    # the port's kernels (fq_mul_kernel, g1_*), then torch's costliest
    ours = [kv for kv in by_kernel.items()
            if kv[0].startswith(("fq_mul", "g1_", "void g1_"))]
    rest = [kv for kv in by_kernel.items() if kv not in ours]
    top = sorted(ours, key=lambda kv: -kv[1][1]) + sorted(
        rest, key=lambda kv: -kv[1][1])[:15]
    return {"tree": str(tree), "warmup_prove_ms": warm_ms,
            "events_prove_ms": events_wall,
            "launch_spans": {k: {"launches": n, "ms": ms}
                             for k, (n, ms) in sorted(by_wrapper.items())},
            "profiled_prove_ms": prof_wall,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / prof_wall if prof_wall else None,
            "kernels_by_device_ms": [{"name": k, "count": n, "ms": ms}
                                     for k, (n, ms) in top]}


def suffix_sweep() -> dict:
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.g1_ops import points_to_device

    dev = torch.device("cuda")
    K.build()
    rng = StdRng.seed_from_u64(5)
    a = points_to_device([rng.rand_g1() for _ in range(256)], dev)
    b = points_to_device([rng.rand_g1() for _ in range(256)], dev)
    p = K.g1_add(a, b)                  # general z
    rows = []
    for cb in (8, 16):
        for wg in (512, 1024, 2048, 4096, 8192, 16384, 32768):
            idx = torch.arange(cb * wg, device=dev) % 256
            xyz = [c[:, idx].reshape(24, cb, wg) for c in p]
            ms = {"chain": [], "tree": []}
            for entry in ("chain", "tree", "tree", "chain"):
                ms[entry].append(graph_ms(
                    lambda: K.g1_suffix_weighted(*xyz, tree=entry == "tree")))
            rows.append({"cb": cb, "wg": wg, "chain_ms": ms["chain"],
                         "tree_ms": ms["tree"],
                         "routed": "tree" if K.suffix_uses_tree(cb, wg)
                         else "chain"})
    return {"suffix_sweep": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("trace", "suffix"))
    ap.add_argument("--tree", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    print(card_line(), flush=True)
    out = trace(tree) if args.what == "trace" else suffix_sweep()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
