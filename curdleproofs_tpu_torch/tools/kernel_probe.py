"""Kernel measurements on one CUDA card, beyond what `chip_smoke.py` checks.

    python curdleproofs_tpu_torch/tools/kernel_probe.py trace [--tree DIR]
    python curdleproofs_tpu_torch/tools/kernel_probe.py suffix
    python curdleproofs_tpu_torch/tools/kernel_probe.py fold [--tree DIR]
    python curdleproofs_tpu_torch/tools/kernel_probe.py sqrt
    python curdleproofs_tpu_torch/tools/kernel_probe.py add
    python curdleproofs_tpu_torch/tools/kernel_probe.py horner-g

`trace`: the l = 124 Whisk shuffle proof of `StdRng.seed_from_u64(0)` (the
golden 4496 bytes, checked) on the card, after one untimed warm-up prove:
one prove with every kernel launch between two CUDA events (ms summed by
wrapper; a span also holds the card's wait for the launch), then one under
`torch.profiler` (device ms summed by CUDA kernel name: every kernel of
the port, then torch's 15 costliest; the card's busy time against the
prove's wall).  `--tree` imports `curdleproofs_tpu_torch`
from another checkout that has the kernel store (`ops/aot.py`; run this
file by its path), so two trees are traced with one script.

`suffix`: g1_suffix_weighted's chain and tree entries at Cb = 8 and 16 over
a sweep of WG, each timed with `graph_ms` in turns (chain, tree, tree,
chain): the crossover that `kernels.SUFFIX_TREE_MAX_WG` is set from.

`fold`: the three folds on the inputs `chip_smoke.py` checks them on
(`fold_data`, `fold_inputs`: the 626k MSM's plan for g1_fold_madd and
g1_fold_packed, [24, 8, 2^17] rows of it for g1_fold_rows), each kernel's
device time by `graph_ms`, each kernel's ptxas registers and spills (as
the kernel store recorded them), and the plan's row kinds (`fold_row_kinds`).  With
`--tree`, one process a tree, taken in turns, times two trees' kernels on
one card.

`sqrt`: g1_sqrt's one-thread and pair entries over a sweep of widths
(SWEEP_SQRT: 64 to 2^17 points, the x of 256 random points tiled), each
timed with `graph_ms` in turns (one thread, pair, pair, one thread), both
outputs equal: the crossing that `kernels.SQRT_PAIR_MAX_N` is set from.

`add`: g1_add's flat and scan entries, one thread a lane against a group
of 8 lanes a point, over SWEEP_ADD (32 to 2^16 lanes, general-z sums of
random points; the scan step with one key, so every lane but the last
adds), in turns as `sqrt`, the outputs equal: the crossing that
`kernels.ADD_GROUP_MAX_N` is set from.

`horner-g`: the G trial of g1_horner (`HornerVariant`, `horner_g_trial`):
`csrc/g1_horner.cu` built with the other `HORNER_G` of HORNER_G_TRIAL
(lanes a relation) into a directory of its own, then timed against the
kernel store's g1_horner in turns (kernel, variant, variant, kernel),
each with `graph_ms`, on the same window sums (general-z sums of random
points at HORNER_G_RELS relations), both outputs equal.

Each prints one JSON line; `nvidia-smi`'s name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

if __package__:
    from .common import card_line, graph_ms
else:   # run by its path: import no package before `--tree` picks one
    from common import card_line, graph_ms

# The 626k MSM (batch verification's deduped MSM at B = 1024, l = 252) whose
# shapes `chip_smoke.py` and `fold` both measure the folds at: FOLD_TILE
# random bases tiled to FOLD_N points, g1_fold_rows on the plan's first
# FOLD_ROWS_S slots.
FOLD_SEED = 2024
FOLD_N, FOLD_TILE, FOLD_ROWS_S = 626_000, 4096, 1 << 17


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
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.backend import TorchBackend

    golden = (tree / "tests" / "golden" /
              "whisk_shuffle_proof_128.hex").read_text().strip()
    aot.export()
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
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.g1_ops import points_to_device

    dev = torch.device("cuda")
    aot.export()
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


def _packed_col(v: int, dev) -> torch.Tensor:
    """A Montgomery int as a [12, 1] column of packed limb pairs (int32
    words, as the resident bases hold them)."""
    w = np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)],
                 dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)[:, None]


def fold_row_kinds(ext_px, ext_py, ext_zb, plan) -> dict:
    """Rows of a [T, S] fold plan over resident bases, by the field products
    the full-add fold's words need (g1_fold.cuh): `live` 11 (the mixed add);
    dead rows (T x S - live) with x = 0, `dead_pm1` 3 where y = +-one (the
    ingest's infinities and sentinel) and `dead_y` 5 elsewhere; `dead_x` 12
    (x not 0).  `products` is their sum, the least work that writes the
    fold's words.  Warp rows (32 neighbouring slots in one row, as one warp
    of the kernel meets them): `warp_live` all live, `warp_dead` all of the
    (0 : y : 0) kind, `warp_mixed` the rest; `warp_products` the products
    g1_fold_packed's warps execute (3, or 5 where a lane's y is not +-one, a
    warp row of `warp_dead`; 12 any other)."""
    from curdleproofs_tpu_torch.constants import Q
    from curdleproofs_tpu_torch.ops.field import FQ

    dev = plan.device
    e = plan.long()
    live = ext_zb[e] != 0
    x0 = (ext_px == 0).all(0)[e]
    pm1 = ((ext_py == _packed_col(FQ.one_mont, dev)).all(0)
           | (ext_py == _packed_col(Q - FQ.one_mont, dev)).all(0))[e]
    t_rows, s = plan.shape
    n_live = int(live.sum())
    kinds = {"rows": t_rows * s, "live": n_live,
             "dead_pm1": int((~live & x0 & pm1).sum()),
             "dead_y": int((~live & x0 & ~pm1).sum()),
             "dead_x": int((~live & ~x0).sum())}
    if n_live + kinds["dead_pm1"] + kinds["dead_y"] + kinds["dead_x"] \
            != t_rows * s:
        raise AssertionError(f"row kinds do not add up: {kinds}")
    kinds["products"] = (11 * n_live + 3 * kinds["dead_pm1"]
                         + 5 * kinds["dead_y"] + 12 * kinds["dead_x"])
    pad = (-s) % 32

    def warps(m, fill):  # lanes past S leave a warp's vote alone
        return torch.nn.functional.pad(m, (0, pad), value=fill).reshape(
            t_rows, -1, 32)

    all_live = warps(live, True).all(-1)
    all_dead = warps(~live & x0, True).all(-1)
    some_y = warps(~live & x0 & ~pm1, False).any(-1)
    mixed = ~all_live & ~all_dead
    kinds.update({"warp_rows": all_live.numel(),
                  "warp_live": int(all_live.sum()),
                  "warp_dead": int(all_dead.sum()),
                  "warp_mixed": int(mixed.sum())})
    kinds["warp_products"] = (
        12 * (kinds["warp_live"] + kinds["warp_mixed"])
        + int((all_dead * (3 + 2 * some_y)).sum()))
    return kinds


def fold_data(rng, rnd) -> tuple[list, list, list]:
    """(tile, points, scalars) of the 626k MSM: FOLD_TILE random bases drawn
    first from `rng` (a `StdRng`), tiled to FOLD_N points, and FOLD_N
    scalars drawn first from `rnd` (a `random.Random`); both generators
    seeded FOLD_SEED by the caller, who may draw on from them."""
    from curdleproofs_tpu_torch.constants import R

    tile = [rng.rand_g1() for _ in range(FOLD_TILE)]
    return (tile, [tile[i % FOLD_TILE] for i in range(FOLD_N)],
            [rnd.randrange(R) for _ in range(FOLD_N)])


def fold_inputs(bases, scalars):
    """(params, ext, sp, rows): what the three folds take at the MSM of
    `scalars` over resident `bases`.  `ext` is the bases' (ext_px, ext_py,
    ext_zb), `sp` the MSM's slot plan (by `pick_params`; the folds take its
    [T, S] `plan`), `rows` the [24, T, FOLD_ROWS_S] projective rows of the
    plan's first slots for g1_fold_rows, z rebuilt from the liveness bit
    (dead rows have z = 0)."""
    from curdleproofs_tpu_torch.ops import msm_device as md
    from curdleproofs_tpu_torch.ops.field import FQ, unpack_pairs

    dev = bases.ext_px.device
    params = md.pick_params(len(scalars), device=dev)
    limbs = torch.from_numpy(
        md._scalars_to_limbs(scalars, params.n).astype(np.int32)).to(dev)
    sp = md._slot_plan(md._signed_digits(limbs, params.n, params.c),
                       n=params.n, c=params.c, t_rows=params.t_rows,
                       s_pad=params.s_pad)
    ext = (bases.ext_px, bases.ext_py, bases.ext_zb)
    cols = sp.plan[:, :FOLD_ROWS_S].long()
    one = FQ.const(1, (1, 1), dev)
    rows = (unpack_pairs(ext[0][:, cols]).int(),
            unpack_pairs(ext[1][:, cols]).int(),
            torch.where(ext[2][cols][None] != 0, one, 0).int())
    return params, ext, sp, rows


def fold_probe() -> dict:
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops import msm_device as md

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    reports = {s: rec["ptxas"] for s, rec in aot.export().items()}
    build_s = time.perf_counter() - t0
    usage = {}
    for src, rep in reports.items():
        for entry in (f"{src}_kernel", "g1_fold_kernel"):
            u = K.ptxas_usage(rep, entry)
            if u:
                usage[src] = u
                break
    _, pts, ss = fold_data(StdRng.seed_from_u64(FOLD_SEED),
                           random.Random(FOLD_SEED))
    _, ext, sp, rows = fold_inputs(md.DeviceBases(pts, dev), ss)
    plan = sp.plan
    ms = {name: graph_ms(lambda: getattr(K, name)(*ext, plan),
                         per_graph=5, replays=4)
          for name in ("g1_fold_madd", "g1_fold_packed")}
    ms["g1_fold_rows"] = graph_ms(lambda: K.g1_fold_rows(*rows))
    return {"fold_probe": {"tree": str(pathlib.Path(K.__file__).parents[2]),
                           "build_s": build_s, "plan": list(plan.shape),
                           "rows_shape": list(rows[0].shape),
                           "kernel_ms": ms, "ptxas": usage,
                           "row_kinds": fold_row_kinds(*ext, plan)}}


def _general_points(n: int, dev, seed: int):
    """[24, n] x3 general-z Montgomery points on `dev`: sums of 256 random
    point pairs (`g1_add` on the card), tiled."""
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ, points_to_device

    rng = StdRng.seed_from_u64(seed)
    a = points_to_device([rng.rand_g1() for _ in range(256)], dev)
    b = points_to_device([rng.rand_g1() for _ in range(256)], dev)
    p = K.g1_add(a, b)
    idx = torch.arange(n, device=dev) % 256
    return PointsXYZ(*(c[:, idx].contiguous() for c in p))


def _in_turns(fns: dict, order) -> dict:
    """`graph_ms` of each of `fns` (name -> call) in the given order: a
    list of ms a name."""
    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(graph_ms(fns[k]))
    return ms


def _crossing(rows, key, old, new) -> int | None:
    """The widest `key` up to which `new` was faster than `old` (the sum of
    its turns) at every width of the sweep; None where it never was."""
    last = None
    for r in rows:
        if sum(r[new]) >= sum(r[old]):
            break
        last = r[key]
    return last


SWEEP_SQRT = (64, 128, 256, 512, 768, 1024, 2048, 4096, 8192, 16384, 32768,
              65536, 131072)


def sqrt_sweep() -> dict:
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops import msm_device as md

    dev = torch.device("cuda")
    reports = aot.export()
    rng = StdRng.seed_from_u64(6)
    pts = [rng.rand_g1() for _ in range(256)]
    rows = []
    for n in SWEEP_SQRT:
        px, _ = native.export_mont_x([pts[i % 256] for i in range(n)], n)
        pxp = md.u32_to_tensor(px, dev)
        if not torch.equal(K.g1_sqrt(pxp, pair=False),
                           K.g1_sqrt(pxp, pair=True)):
            raise AssertionError(f"g1_sqrt's entries differ at n = {n}")
        ms = _in_turns({"one_ms": lambda: K.g1_sqrt(pxp, pair=False),
                        "pair_ms": lambda: K.g1_sqrt(pxp, pair=True)},
                       ("one_ms", "pair_ms", "pair_ms", "one_ms"))
        rows.append({"n": n, **ms,
                     "routed": "pair" if K.sqrt_uses_pair(n) else "one"})
    rep = reports["g1_sqrt"]["ptxas"]
    return {"sqrt_sweep": rows,
            "pair_faster_up_to": _crossing(rows, "n", "one_ms", "pair_ms"),
            "ptxas": {e: K.ptxas_usage(rep, e + "_kernel")
                      for e in ("g1_sqrt", "g1_sqrt_pair")}}


SWEEP_ADD = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
             65536)


def add_sweep() -> dict:
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ

    dev = torch.device("cuda")
    reports = aot.export()
    big = SWEEP_ADD[-1]
    p_all = _general_points(big, dev, 7)
    q_all = _general_points(big, dev, 8)
    rows = []
    for n in SWEEP_ADD:
        p, q = (PointsXYZ(*(c[:, :n].contiguous() for c in v))
                for v in (p_all, q_all))
        key = torch.zeros(n, dtype=torch.int64, device=dev)
        calls = {
            "one_ms": lambda: K.g1_add(p, q, group=False),
            "group_ms": lambda: K.g1_add(p, q, group=True),
            "scan_one_ms": lambda: K.g1_add_scan(p, key, 1, group=False),
            "scan_group_ms": lambda: K.g1_add_scan(p, key, 1, group=True)}
        for a, b in (("one_ms", "group_ms"), ("scan_one_ms", "scan_group_ms")):
            if not all(torch.equal(x, y) for x, y in
                       zip(calls[a](), calls[b]())):
                raise AssertionError(f"g1_add's {a} and {b} entries differ "
                                     f"at n = {n}")
        ms = _in_turns(calls, ("one_ms", "group_ms", "scan_one_ms",
                               "scan_group_ms", "scan_group_ms",
                               "scan_one_ms", "group_ms", "one_ms"))
        rows.append({"n": n, **ms,
                     "routed": "group" if K.add_uses_group(n) else "one"})
    flat = _crossing(rows, "n", "one_ms", "group_ms")
    scan = _crossing(rows, "n", "scan_one_ms", "scan_group_ms")
    rep = reports["g1_add"]["ptxas"]
    return {"add_sweep": rows, "group_faster_up_to": {"flat": flat,
                                                      "scan": scan},
            "ptxas": {e: K.ptxas_usage(rep, e + "_kernel")
                      for e in ("g1_add", "g1_add_scan", "g1_add_group",
                                "g1_add_scan_group")}}


_HORNER_G = re.compile(r"constexpr int HORNER_G = (\d+);")
HORNER_G_TRIAL = (4, 8)   # the lanes a relation the G trial sets apart
# g1_horner's widths: a same-msm round's relations (6 a proof) in the
# batched prover's table mode at B = 256 and its slot mode at B = 16
HORNER_G_RELS = (1536, 96)


def horner_g() -> int:
    """`HORNER_G` of csrc/g1_horner.cu: the kernel's lanes a relation."""
    from curdleproofs_tpu_torch.ops import aot

    return int(_HORNER_G.search((aot.CSRC / "g1_horner.cu").read_text())
               .group(1))


class HornerVariant:
    """`csrc/g1_horner.cu` with the other `HORNER_G` of HORNER_G_TRIAL than
    the source's own, built by nvcc (the kernel store's flags) into
    `directory`; the build starts at construction and runs beside the
    caller's work until `launcher()`."""

    def __init__(self, directory: pathlib.Path):
        from curdleproofs_tpu_torch.ops import aot

        src = (aot.CSRC / "g1_horner.cu").read_text()
        self.shipped_g = horner_g()
        g = self.g = next(g for g in HORNER_G_TRIAL if g != self.shipped_g)
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        for f in ("fq_cc.cuh", "g1_group.cuh", "g1_horner.cuh"):
            shutil.copy(aot.CSRC / f, d / f)
        (d / "g1_horner.cu").write_text(
            _HORNER_G.sub(f"constexpr int HORNER_G = {g};", src))
        self.so = d / "libg1_horner.so"
        self.log = d / "nvcc.log"
        self._t0 = time.perf_counter()
        with open(self.log, "w") as out:
            self._proc = subprocess.Popen(
                [aot._nvcc(), *aot.NVCC_FLAGS, "-I", str(d), "-o",
                 str(self.so), str(d / "g1_horner.cu")],
                stdout=out, stderr=subprocess.STDOUT)

    def launcher(self):
        """Wait for the build; (launch(x, y, z) -> [3, 24, n_rel] on the
        current stream, the ptxas report, nvcc seconds)."""
        import ctypes

        rc = self._proc.wait()
        build_s = time.perf_counter() - self._t0
        report = self.log.read_text()
        if rc != 0:
            raise RuntimeError(f"g1_horner with HORNER_G = {self.g} failed "
                               f"to build:\n{report}")
        fn = ctypes.CDLL(str(self.so)).cp_g1_horner
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch(x, y, z):
            x, y, z = (t.contiguous() for t in (x, y, z))
            out = torch.empty((3, 24, x.shape[1]), dtype=torch.int32,
                              device=x.device)
            rc = fn(x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(),
                    x.shape[1], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"g1_horner variant: cudaError {rc}")
            return out

        return launch, report, build_s


def horner_g_trial(variant: HornerVariant, window_sums) -> dict:
    """The kernel store's g1_horner against `variant` on each of
    `window_sums` ([24, n_rel, 64] x 3 on the card), in turns (kernel,
    variant, variant, kernel), each turn `graph_ms` of 5 launches replayed
    4 times; the two outputs must be equal (the same field operations)."""
    from curdleproofs_tpu_torch.ops import kernels as K

    launch, report, build_s = variant.launcher()
    g0, g1 = variant.shipped_g, variant.g
    fns = {g0: K.g1_horner, g1: launch}
    ms = {g0: {}, g1: {}}
    for ws in window_sums:
        ws = tuple(c.contiguous() for c in ws)   # no copy in the turns
        n_rel = ws[0].shape[1]
        if not torch.equal(K.g1_horner(*ws), launch(*ws)):
            raise AssertionError(f"g1_horner at HORNER_G = {g0} and {g1} "
                                 f"differ at n_rel = {n_rel}")
        for g in (g0, g1, g1, g0):
            ms[g].setdefault(str(n_rel), []).append(
                graph_ms(lambda: fns[g](*ws), per_graph=5, replays=4))
    return {"turns": f"G = {g0}, {g1}, {g1}, {g0}",
            "ms": {str(g): v for g, v in ms.items()},
            "variant_ptxas": K.ptxas_usage(report, "g1_horner_kernel"),
            "variant_build_s": build_s}


def horner_g_probe() -> dict:
    """The G trial on general-z window sums at HORNER_G_RELS relations."""
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ

    dev = torch.device("cuda")
    aot.export()
    p = _general_points(max(HORNER_G_RELS) * 64, dev, 9)
    sums = [PointsXYZ(*(c[:, :n_rel * 64].reshape(24, n_rel, 64)
                        for c in p)) for n_rel in HORNER_G_RELS]
    return {"horner_g_trial": horner_g_trial(
        HornerVariant(aot.aot_dir() / "g1_horner_trial"), sums)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("trace", "suffix", "fold", "sqrt", "add",
                                     "horner-g"))
    ap.add_argument("--tree", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    print(card_line(), flush=True)
    out = {"trace": lambda: trace(tree), "suffix": suffix_sweep,
           "fold": fold_probe, "sqrt": sqrt_sweep, "add": add_sweep,
           "horner-g": horner_g_probe}[args.what]()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
