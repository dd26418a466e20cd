"""The hand-written CUDA kernels of the MSM path, their wrappers, and beside
each its plain PyTorch version.

Kernels (sources in `../csrc/`, one shared object each):
- `fq_mul`             batched Montgomery product          (fq_mul.cu)
- `g1_add`             complete projective add, and one    (g1_add.cu)
                       round of a masked suffix scan
                       (`g1_add_scan`, its second entry)
- `g1_fold_madd`       Pippenger bucket fold, mixed adds   (g1_fold_madd.cu)
- `g1_suffix_weighted` bucket-reduction inner step,        (g1_suffix_weighted.cu)
                       routed by shape to its chain entry
                       or to its tree entry
                       (`g1_suffix_weighted_tree`)
- `g1_fold_packed`     Pippenger bucket fold, full adds    (g1_fold_packed.cu)
- `g1_sqrt`            y from x, compressed base ingest    (g1_sqrt.cu)
- `g1_fold_rows`       fold of gathered [24, T, S] rows    (g1_fold_rows.cu)
- `g1_add_rows`        batched add on [24, N] 3-tuples     (launches g1_add.cu)
- `g1_ladder`          255-step double-and-add ladders:    (g1_ladder.cu)
                       k * P (one scalar), k_i * P_i and
                       L + k * R, one entry each

Every source runs on the carry-chain field core `fq_cc.cuh`; the two
bucket folds share their repack, slot loop and launch (`g1_fold.cuh`) and
differ in the row step.

Each wrapper takes the reference layouts as int32 tensors (16-bit limbs
`[24, ...]`, packed limb pairs `[12, ...]`; the kernels read them as
uint32).  For a tensor on the CPU it runs the plain version; for a CUDA
tensor it launches the kernel, or raises.  `LAUNCHES` counts kernel launches
per wrapper, so a run can show its main path went through the kernels
(`g1_add_rows` counts its own launches of g1_add.cu's entry; `g1_add_scan`
counts under `g1_add`; the tree entry of g1_suffix_weighted.cu counts under
`g1_suffix_weighted_tree`; the ladder's three entries count under
`g1_ladder`).

Build: `nvcc -gencode arch=compute_90a,code=sm_90a` into `../_build/cuda/`
at first use, one process per source, all started together (`build()`),
with the generated `sqrt_constants.h` (from `constants.py`) beside them.
Every C entry returns `cudaGetLastError()`, and the wrapper raises on non-0.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

from ..constants import CURVE_B, Q
from .field import FQ, limb_col, mul_rows, unpack_pairs
from .g1_ops import (
    PointsXYZ, g1_add64, g1_double64, g1_infinity64, g1_madd64, g1_select,
)
from .limbs import FQ_LIMBS as L

__all__ = ["KERNELS", "LAUNCHES", "SQRT_DIGITS", "build", "reset_launches",
           "write_constants",
           "fq_mul", "fq_mul_plain", "g1_add", "g1_add_plain",
           "g1_add_scan", "g1_add_scan_plain",
           "g1_fold_madd", "g1_fold_madd_plain",
           "g1_fold_packed", "g1_fold_packed_plain",
           "g1_suffix_weighted", "g1_suffix_weighted_plain",
           "g1_suffix_weighted_tree", "g1_suffix_weighted_tree_plain",
           "suffix_uses_tree",
           "g1_sqrt", "g1_sqrt_plain", "g1_fold_rows", "g1_fold_rows_plain",
           "g1_add_rows", "g1_add_rows_plain", "g1_ladder",
           "g1_ladder_plain", "source_of", "ptxas_usage"]

KERNELS = ("fq_mul", "g1_add", "g1_fold_madd", "g1_suffix_weighted",
           "g1_suffix_weighted_tree", "g1_fold_packed", "g1_sqrt",
           "g1_fold_rows", "g1_add_rows", "g1_ladder")
# the wrappers that launch another kernel's source (and its C entry)
_SHARES_SOURCE = {"g1_add_rows": "g1_add",
                  "g1_suffix_weighted_tree": "g1_suffix_weighted"}
SOURCES = tuple(k for k in KERNELS if k not in _SHARES_SOURCE)
LAUNCHES = {k: 0 for k in KERNELS}
_LAUNCHES_LOCK = threading.Lock()  # a stream's worker thread launches too

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parent / "_build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "fq_mul": [_P, _I64, _P, _I64, _P, _I64, _P],
    "g1_add": [_P] * 9 + [_I64, _P],
    "g1_add_scan": [_P] * 4 + [_I64, _I64] + [_P] * 4,
    "g1_fold_madd": [_P, _P, _P, _P, _I64, ctypes.c_int, _I64] + [_P] * 5,
    "g1_suffix_weighted": [_P, _P, _P, ctypes.c_int, _I64] + [_P] * 7,
    "g1_suffix_weighted_tree": [_P, _P, _P, ctypes.c_int, _I64] + [_P] * 7,
    "g1_fold_packed": [_P, _P, _P, _P, _I64, ctypes.c_int, _I64] + [_P] * 5,
    "g1_sqrt": [_P, _I64, _P, _P],
    "g1_fold_rows": [_P, _P, _P, ctypes.c_int, _I64, _P, _P, _P, _P],
    "g1_batch_mul": [_P] * 7 + [_I64, _P],
    "g1_batch_mul_each": [_P] * 7 + [_I64, _P],
    "g1_fold": [_P] * 10 + [_I64, _P],
}


def _sqrt_digits() -> tuple[int, ...]:
    """(q+1)/4 as MSB-first 2-bit digits for the windowed powering chain."""
    e = (Q + 1) // 4
    nb = e.bit_length()
    nb += nb & 1
    return tuple((e >> (nb - 2 * (j + 1))) & 3 for j in range(nb // 2))


SQRT_DIGITS = _sqrt_digits()


def source_of(name: str) -> str:
    """The `csrc/<source>.cu` (and C entry `cp_<source>`) a kernel launches."""
    return _SHARES_SOURCE.get(name, name)


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use")


def _so(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _fresh(name: str) -> bool:
    """Built after its source, the shared headers and this module (which
    generates `sqrt_constants.h`)."""
    so = _so(name)
    srcs = [CSRC / f"{name}.cu", pathlib.Path(__file__), *CSRC.glob("*.cuh")]
    return so.exists() and so.stat().st_mtime > max(s.stat().st_mtime
                                                    for s in srcs)


def _u32s(x: int, n: int) -> str:
    return ", ".join(f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(n))


def write_constants(directory: pathlib.Path = BUILD_DIR) -> None:
    """`sqrt_constants.h` for g1_sqrt.cuh, from the port's constants, into
    `directory` (the build's include directory)."""
    digits = ", ".join(map(str, SQRT_DIGITS))
    (directory / "sqrt_constants.h").write_text(f"""\
// generated by curdleproofs_tpu_torch/ops/kernels.py; do not edit
#pragma once
#include <stdint.h>
namespace cc {{
// b = {CURVE_B} in Montgomery form (R = 2^384), 12 x 32-bit limbs
CC_CONST const uint32_t B_MONT[12] = {{{_u32s(FQ.to_mont(CURVE_B), 12)}}};
// (q+1)/4 as two-bit digits, most significant first
constexpr int SQRT_NDIGITS = {len(SQRT_DIGITS)};
CC_CONST const uint8_t SQRT_DIGITS[SQRT_NDIGITS] = {{{digits}}};
}}  // namespace cc
""")


def build(force: bool = False) -> dict[str, str]:
    """Compile every stale kernel, one nvcc per source, all in parallel.
    Returns each built kernel's ptxas report (registers, spills); raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports: dict[str, str] = {}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [k for k in SOURCES if force or not _fresh(k)]
        nvcc = _nvcc() if todo else ""
        write_constants()
        procs = {}
        for k in todo:
            tmp = _so(k).with_suffix(f".so.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(BUILD_DIR), "-o", str(tmp),
                   str(CSRC / f"{k}.cu")]
            procs[k] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for k, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            reports[k] = out
            if proc.returncode != 0:
                failed.append(f"--- {k} ---\n{out}")
            else:
                tmp.replace(_so(k))
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def ptxas_usage(report: str, kernel: str) -> dict[str, int]:
    """`registers`, `spill_bytes` (stores + loads) and `stack_bytes` (the
    stack frame) that ptxas -v reported for the kernel entry whose name
    contains `kernel`."""
    out, entry, props = {}, False, False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = kernel in line
        elif "Function properties for" in line:
            props = kernel in line
        elif entry and re.search(r"Used \d+ registers", line):
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
        elif props and "spill" in line:
            out["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", line))
            out["stack_bytes"] = int(re.search(r"(\d+) bytes stack frame",
                                               line).group(1))
    return out


@functools.cache
def _lib(source: str, entry: str):
    if not _fresh(source):
        build()
    fn = getattr(ctypes.CDLL(str(_so(source))), f"cp_{entry}")
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device: torch.device, *args, entry=None) -> None:
    """Launch C entry `cp_<entry>` (default: the kernel's own source's) of
    the kernel's source and count it under `name`."""
    fn = _lib(source_of(name), entry or source_of(name))
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); a CUDA tensor
    needs all of them on that card, as int32."""
    devs = {t.device for t in ts}
    if devs == {torch.device("cpu")}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError("kernel inputs on mixed devices: "
                         f"{sorted(map(str, devs))}")
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError("kernel inputs are int32 limb tensors, got "
                            f"{t.dtype}")
    return False


# --------------------------------------------------------------------------
# fq_mul
# --------------------------------------------------------------------------

def fq_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[24, *b] int32 Montgomery residues -> a * b * R^-1 (broadcasting)."""
    return mul_rows(a.long(), b.long(), FQ.modulus, FQ.n0_inv).int()


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`fq_mul_plain` in one launch.  An operand of a single element (such
    as the plain 1 of leave-Montgomery) goes to the kernel as its one column,
    which every lane reads; any other broadcast is materialised."""
    if _on_cpu(a, b):
        return fq_mul_plain(a, b)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a, b = (t.reshape(L, 1).contiguous() if t[0].numel() == 1
            else t.expand(L, *batch).reshape(L, -1).contiguous()
            for t in (a, b))
    n = max(a.shape[1], b.shape[1]) if batch.numel() else 0
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    if n:
        _launch("fq_mul", a.device, a.data_ptr(), a.shape[1], b.data_ptr(),
                b.shape[1], out.data_ptr(), n)
    return out.reshape(L, *batch)


# --------------------------------------------------------------------------
# g1_add
# --------------------------------------------------------------------------

def g1_add_plain(p: PointsXYZ, q: PointsXYZ) -> PointsXYZ:
    r = g1_add64(PointsXYZ(*(c.long() for c in p)),
                 PointsXYZ(*(c.long() for c in q)))
    return PointsXYZ(*(c.int() for c in r))


def g1_add(p: PointsXYZ, q: PointsXYZ) -> PointsXYZ:
    """Complete add of [24, *batch] point batches (broadcasting)."""
    if _on_cpu(*p, *q):
        return g1_add_plain(p, q)
    batch = torch.broadcast_shapes(*(c.shape[1:] for c in (*p, *q)))
    ins = [c.expand(L, *batch).reshape(L, -1).contiguous() for c in (*p, *q)]
    n = ins[0].shape[1]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("g1_add", ins[0].device,
                *(t.data_ptr() for t in (*ins, *outs)), n)
    return PointsXYZ(*(o.reshape(L, *batch) for o in outs))


def g1_add_scan_plain(v: PointsXYZ, key: torch.Tensor,
                      stride: int) -> PointsXYZ:
    """One round of a masked Hillis-Steele suffix scan over [24, n] points:
    lane i adds lane i + stride where that lane exists and holds the same
    key ([n] int64), and keeps its point elsewhere."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    partner = torch.clamp(idx + stride, max=n - 1)
    mask = ((key[partner] == key) & (idx + stride < n))[None]
    s = g1_add_plain(v, PointsXYZ(*(c[:, partner] for c in v)))
    return PointsXYZ(*(torch.where(mask, a, b) for a, b in zip(s, v)))


def g1_add_scan(v: PointsXYZ, key: torch.Tensor, stride: int) -> PointsXYZ:
    """`g1_add_scan_plain` in one launch of g1_add.cu's scan entry, which
    reads the partner by index, compares the keys on the card and writes out
    of place; counted under `g1_add`."""
    if _on_cpu(*v):
        return g1_add_scan_plain(v, key, stride)
    n = key.shape[0] if key.ndim == 1 else -1
    if key.device != v.x.device or key.dtype != torch.int64 or n < 0 \
            or any(c.shape != (L, n) for c in v) or stride < 1:
        raise ValueError("scan step takes three [24, n] limb tensors, an "
                         "[n] int64 key on their card and a stride >= 1")
    ins = [c.contiguous() for c in v]
    key = key.contiguous()
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("g1_add", key.device, *(t.data_ptr() for t in (*ins, key)),
                stride, n, *(o.data_ptr() for o in outs), entry="g1_add_scan")
    return PointsXYZ(*outs)


# --------------------------------------------------------------------------
# g1_fold_madd
# --------------------------------------------------------------------------

def g1_fold_madd_plain(ext_px, ext_py, ext_zb, plan) -> PointsXYZ:
    """Gather, then fold: slot s accumulates the bases ext[:, plan[t, s]] for
    t = 0..T-1 with the complete mixed add; rows whose liveness bit is 0 keep
    the accumulator.  ext_*: [12, E] pairs / [E] bits; plan: [T, S]."""
    t_rows, s_pad = plan.shape
    acc = [c.clone() for c in g1_infinity64((s_pad,), plan.device)]
    for t in range(t_rows):
        row = plan[t].long()
        # only live rows change the accumulator, so only they are computed
        lanes = torch.nonzero(ext_zb[row] != 0).squeeze(1)
        e = row[lanes]
        r = g1_madd64(PointsXYZ(*(a[:, lanes] for a in acc)),
                      unpack_pairs(ext_px[:, e]),
                      unpack_pairs(ext_py[:, e]))
        for a, v in zip(acc, r):
            a[:, lanes] = v
    return PointsXYZ(*(c.int() for c in acc))


def g1_fold_madd(ext_px, ext_py, ext_zb, plan) -> PointsXYZ:
    """The bucket fold over resident bases; returns [24, S] x3 projective
    Montgomery (see `g1_fold_madd_plain` for the function)."""
    if _on_cpu(ext_px, ext_py, ext_zb, plan):
        return g1_fold_madd_plain(ext_px, ext_py, ext_zb, plan)
    return _fold_launch("g1_fold_madd", ext_px, ext_py, ext_zb, plan)


def _fold_launch(name, ext_px, ext_py, ext_zb, plan) -> PointsXYZ:
    """Launch either fold kernel (one interface, g1_fold.cuh's launch): it
    repacks the bases point-major into an [E, 24] scratch, then folds."""
    n_ext = ext_px.shape[1]
    if ext_px.shape != (L // 2, n_ext) or ext_py.shape != ext_px.shape \
            or ext_zb.shape != (n_ext,) or plan.ndim != 2:
        raise ValueError("fold takes [12, E] pairs, [E] bits and a [T, S] plan")
    ext_px, ext_py, ext_zb, plan = (t.contiguous() for t in
                                    (ext_px, ext_py, ext_zb, plan))
    t_rows, s_pad = plan.shape
    pts = torch.empty((n_ext, L), dtype=torch.int32, device=plan.device)
    outs = [torch.empty((L, s_pad), dtype=torch.int32, device=plan.device)
            for _ in range(3)]
    if s_pad:
        _launch(name, plan.device,
                *(t.data_ptr() for t in (ext_px, ext_py, ext_zb, plan)),
                n_ext, t_rows, s_pad,
                *(t.data_ptr() for t in (pts, *outs)))
    return PointsXYZ(*outs)


# --------------------------------------------------------------------------
# g1_suffix_weighted
# --------------------------------------------------------------------------

def g1_suffix_weighted_plain(x, y, z) -> tuple[PointsXYZ, PointsXYZ]:
    """x, y, z: [24, Cb, WG] bucket points -> (total, weighted), each
    [24, WG] x3: total = sum_j P_j, weighted = sum_j (j+1) P_j, accumulated
    from the highest bucket down with complete adds."""
    cb, wg = x.shape[1], x.shape[2]
    suf = g1_infinity64((wg,), x.device)
    w = suf
    for i in range(cb):
        j = cb - 1 - i
        q = PointsXYZ(x[:, j].long(), y[:, j].long(), z[:, j].long())
        suf = g1_add64(suf, q)
        w = g1_add64(w, suf)
    return (PointsXYZ(*(c.int() for c in suf)),
            PointsXYZ(*(c.int() for c in w)))


def g1_suffix_weighted_tree_plain(x, y, z) -> tuple[PointsXYZ, PointsXYZ]:
    """The tree entry's order of adds, Cb a power of two: a Hillis-Steele
    suffix scan over the buckets (round s: S_j = S_j + S_{j+s} where
    j + s < Cb), total = S_0, then a pairwise tree sum of the S_j
    (T_j = T_{2j} + T_{2j+1}, round by round) gives weighted.  The same
    points as `g1_suffix_weighted_plain`, other projective representatives."""
    cb = x.shape[1]
    if cb & (cb - 1):
        raise ValueError(f"the tree takes Cb a power of two, got {cb}")
    v = PointsXYZ(x.long(), y.long(), z.long())
    s = 1
    while s < cb:
        head = g1_add64(PointsXYZ(*(c[:, :cb - s] for c in v)),
                        PointsXYZ(*(c[:, s:] for c in v)))
        v = PointsXYZ(*(torch.cat([h, c[:, cb - s:]], dim=1)
                        for h, c in zip(head, v)))
        s *= 2
    total = PointsXYZ(*(c[:, 0].int() for c in v))
    while v.x.shape[1] > 1:
        v = g1_add64(PointsXYZ(*(c[:, 0::2] for c in v)),
                     PointsXYZ(*(c[:, 1::2] for c in v)))
    return total, PointsXYZ(*(c[:, 0].int() for c in v))


# The tree entry serves Cb in {8, 16} up to this many lanes (WG), the widest
# at which it beat the chain at both Cb on an H100 (`kernel_probe.py
# suffix`; PERF.md): the c = 8 reduction's 512 lanes go to the tree, the
# c = 16 reduction's 32,768 to the chain, which fills the card there while
# the tree would do log2 Cb times its adds.
SUFFIX_TREE_MAX_WG = 8192


def suffix_uses_tree(cb: int, wg: int) -> bool:
    """Whether `g1_suffix_weighted` sends a [24, Cb, WG] launch to the
    tree entry."""
    return cb in (8, 16) and wg <= SUFFIX_TREE_MAX_WG


def _suffix_launch(name, x, y, z) -> tuple[PointsXYZ, PointsXYZ]:
    if x.ndim != 3 or x.shape[0] != L or y.shape != x.shape \
            or z.shape != x.shape:
        raise ValueError("suffix takes three [24, Cb, WG] limb tensors")
    x, y, z = (t.contiguous() for t in (x, y, z))
    cb, wg = x.shape[1], x.shape[2]
    outs = [torch.empty((L, wg), dtype=torch.int32, device=x.device)
            for _ in range(6)]
    if wg:
        _launch(name, x.device, *(t.data_ptr() for t in (x, y, z)), cb, wg,
                *(t.data_ptr() for t in outs), entry=name)
    return PointsXYZ(*outs[:3]), PointsXYZ(*outs[3:])


def g1_suffix_weighted(x, y, z, tree: bool | None = None
                       ) -> tuple[PointsXYZ, PointsXYZ]:
    """(total, weighted) of [24, Cb, WG] buckets.  On the card the launch
    goes to the tree entry where `suffix_uses_tree` says so (its sums are
    `g1_suffix_weighted_tree_plain`'s representatives), else to the chain
    entry (`g1_suffix_weighted_plain`'s); `tree` forces one of them."""
    if _on_cpu(x, y, z):
        return g1_suffix_weighted_plain(x, y, z)
    if tree is None:
        tree = x.ndim == 3 and suffix_uses_tree(x.shape[1], x.shape[2])
    if tree:
        return g1_suffix_weighted_tree(x, y, z)
    return _suffix_launch("g1_suffix_weighted", x, y, z)


def g1_suffix_weighted_tree(x, y, z) -> tuple[PointsXYZ, PointsXYZ]:
    """The tree entry (Cb = 8 or 16) of g1_suffix_weighted.cu; on the CPU
    `g1_suffix_weighted_tree_plain`."""
    if _on_cpu(x, y, z):
        return g1_suffix_weighted_tree_plain(x, y, z)
    if x.ndim != 3 or x.shape[1] not in (8, 16):
        raise ValueError("the tree entry takes [24, Cb, WG] with Cb = 8 or "
                         "16")
    return _suffix_launch("g1_suffix_weighted_tree", x, y, z)


# --------------------------------------------------------------------------
# g1_fold_packed
# --------------------------------------------------------------------------

def g1_fold_packed_plain(ext_px, ext_py, ext_zb, plan) -> PointsXYZ:
    """Gather, then fold with the complete add: slot s accumulates the
    bases ext[:, plan[t, s]] for t = 0..T-1, each with z = Montgomery one
    where its liveness bit is set and 0 where not; every row is added, dead
    rows too (the reference's full-add fold).  ext_*: [12, E] pairs / [E]
    bits; plan: [T, S]."""
    t_rows, s_pad = plan.shape
    one = limb_col(FQ.one_mont, L, plan.device)
    acc = g1_infinity64((s_pad,), plan.device)
    for t in range(t_rows):
        row = plan[t].long()
        qz = torch.where(ext_zb[row][None] != 0, one, 0)
        acc = g1_add64(acc, PointsXYZ(unpack_pairs(ext_px[:, row]),
                                      unpack_pairs(ext_py[:, row]), qz))
    return PointsXYZ(*(c.int() for c in acc))


def g1_fold_packed(ext_px, ext_py, ext_zb, plan) -> PointsXYZ:
    """The full-add bucket fold over resident bases; returns [24, S] x3
    projective Montgomery (see `g1_fold_packed_plain` for the function)."""
    if _on_cpu(ext_px, ext_py, ext_zb, plan):
        return g1_fold_packed_plain(ext_px, ext_py, ext_zb, plan)
    return _fold_launch("g1_fold_packed", ext_px, ext_py, ext_zb, plan)


# --------------------------------------------------------------------------
# g1_sqrt
# --------------------------------------------------------------------------

def g1_sqrt_plain(pxp: torch.Tensor) -> torch.Tensor:
    """[12, n] packed Montgomery x -> [24, n] Montgomery y-candidate
    (x^3 + b)^((q+1)/4), by the kernel's chain: u = x^3 + b, then per
    digit d of SQRT_DIGITS two squarings and a multiply by u^d (u^0 =
    Montgomery one).  The JAX package's jnp twin of the TPU kernel."""
    x = unpack_pairs(pxp)
    mul = FQ.mul64
    u = FQ.add64(mul(mul(x, x), x), limb_col(FQ.to_mont(CURVE_B), L, x.device))
    one = limb_col(FQ.one_mont, L, x.device).expand_as(x)
    u2 = mul(u, u)
    tab = (one, u, u2, mul(u2, u))
    acc = one
    for d in SQRT_DIGITS:
        acc = mul(acc, acc)
        acc = mul(acc, acc)
        acc = mul(acc, tab[d])
    return acc.int()


def g1_sqrt(pxp: torch.Tensor) -> torch.Tensor:
    """y-candidates of packed x [12, n] (see `g1_sqrt_plain`); the caller
    fixes the sign and the dead lanes."""
    if _on_cpu(pxp):
        return g1_sqrt_plain(pxp)
    if pxp.ndim != 2 or pxp.shape[0] != L // 2:
        raise ValueError("sqrt takes [12, n] packed limb pairs")
    pxp = pxp.contiguous()
    n = pxp.shape[1]
    out = torch.empty((L, n), dtype=torch.int32, device=pxp.device)
    if n:
        _launch("g1_sqrt", pxp.device, pxp.data_ptr(), n, out.data_ptr())
    return out


# --------------------------------------------------------------------------
# g1_fold_rows
# --------------------------------------------------------------------------

def g1_fold_rows_plain(x, y, z) -> PointsXYZ:
    """x, y, z: [24, T, S] projective rows -> [24, S] x3: column s starts at
    infinity and complete-adds rows t = 0..T-1 in order, every row (z = 0
    rows too), as the reference's `g1_fold_rows_pallas`."""
    acc = g1_infinity64((x.shape[2],), x.device)
    for t in range(x.shape[1]):
        acc = g1_add64(acc, PointsXYZ(x[:, t].long(), y[:, t].long(),
                                      z[:, t].long()))
    return PointsXYZ(*(c.int() for c in acc))


def g1_fold_rows(x, y, z) -> PointsXYZ:
    """The fold of pre-gathered rows (see `g1_fold_rows_plain`); any T >= 1
    and S >= 1."""
    if _on_cpu(x, y, z):
        return g1_fold_rows_plain(x, y, z)
    if x.ndim != 3 or x.shape[0] != L or x.shape[1] < 1 \
            or y.shape != x.shape or z.shape != x.shape:
        raise ValueError("fold_rows takes three [24, T, S] limb tensors, "
                         "T >= 1")
    x, y, z = (t.contiguous() for t in (x, y, z))
    t_rows, s = x.shape[1], x.shape[2]
    outs = [torch.empty((L, s), dtype=torch.int32, device=x.device)
            for _ in range(3)]
    if s:
        _launch("g1_fold_rows", x.device, *(t.data_ptr() for t in (x, y, z)),
                t_rows, s, *(t.data_ptr() for t in outs))
    return PointsXYZ(*outs)


# --------------------------------------------------------------------------
# g1_add_rows
# --------------------------------------------------------------------------

def g1_add_rows_plain(p: PointsXYZ, q: PointsXYZ) -> PointsXYZ:
    """Batched complete add of [24, N] 3-tuples, as the reference's
    `g1_add_pallas`."""
    return g1_add_plain(p, q)


def g1_add_rows(p: PointsXYZ, q: PointsXYZ) -> PointsXYZ:
    """The reference's `g1_add_pallas`: six [24, N] limb tensors of one
    shape, no broadcasting; launches g1_add.cu's kernel."""
    if _on_cpu(*p, *q):
        return g1_add_rows_plain(p, q)
    shape = p[0].shape
    if len(shape) != 2 or shape[0] != L \
            or any(c.shape != shape for c in (*p, *q)):
        raise ValueError("add_rows takes six [24, N] limb tensors of one "
                         "shape")
    ins = [c.contiguous() for c in (*p, *q)]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if shape[1]:
        _launch("g1_add_rows", ins[0].device,
                *(t.data_ptr() for t in (*ins, *outs)), shape[1])
    return PointsXYZ(*outs)


# --------------------------------------------------------------------------
# g1_ladder
# --------------------------------------------------------------------------

LADDER_BITS = 255  # scalars below r < 2^255


def _bit(words: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i of [8] or [8, N] int32 scalar words (little-endian): [] or [N]."""
    return ((words[i >> 5].long() & 0xFFFFFFFF) >> (i & 31)) & 1


def g1_ladder_plain(points: PointsXYZ, words: torch.Tensor,
                    left: PointsXYZ | None = None) -> PointsXYZ:
    """k * P for [24, N] points and scalars k as int32 words, [8] (one
    scalar for every point) or [8, N] (one a point): from acc = infinity,
    for bit 254 down to 0, acc = double(acc), then acc + P where the bit is
    set, the reference's `lax.scan` step (curdleproofs_tpu/ops/msm.py; with
    one scalar a point both sides are computed and selected, as there).
    With `left`, left + k * P (its `fold_kernel`)."""
    n = points.x.shape[1]
    p = PointsXYZ(*(c.long() for c in points))
    acc = g1_infinity64((n,), points.x.device)
    for i in range(LADDER_BITS - 1, -1, -1):
        acc = g1_double64(acc)
        bit = _bit(words, i)
        if words.ndim == 2:
            acc = g1_select(bit.bool(), g1_add64(acc, p), acc)
        elif bit:   # one scalar: the select would keep acc on a zero bit
            acc = g1_add64(acc, p)
    if left is not None:
        acc = g1_add64(PointsXYZ(*(c.long() for c in left)), acc)
    return PointsXYZ(*(c.int() for c in acc))


def g1_ladder(points: PointsXYZ, words: torch.Tensor,
              left: PointsXYZ | None = None) -> PointsXYZ:
    """`g1_ladder_plain` in one launch: entry `cp_g1_batch_mul` for [8]
    words, `cp_g1_batch_mul_each` for [8, N], `cp_g1_fold` for [8] words
    with `left`."""
    ins = (*points, words, *(left or ()))
    if _on_cpu(*ins):
        return g1_ladder_plain(points, words, left)
    n = points.x.shape[1] if points.x.ndim == 2 else -1
    uniform = words.shape == (8,)
    if n < 0 or any(c.shape != (L, n) for c in (*points, *(left or ()))) \
            or not (uniform or words.shape == (8, n)) \
            or (left is not None and not uniform):
        raise ValueError("the ladder takes [24, N] limb tensors, [8] or "
                         "[8, N] scalar words, and one scalar for a fold")
    ins = [t.contiguous() for t in ins]
    outs = [torch.empty((L, n), dtype=torch.int32, device=words.device)
            for _ in range(3)]
    if not n:
        return PointsXYZ(*outs)
    ptrs = [t.data_ptr() for t in ins]
    if left is not None:   # left, then right and the words, as cp_g1_fold
        ptrs = ptrs[4:] + ptrs[:4]
        entry = "g1_fold"
    else:
        entry = "g1_batch_mul" if uniform else "g1_batch_mul_each"
    _launch("g1_ladder", words.device, *ptrs,
            *(o.data_ptr() for o in outs), n, entry=entry)
    return PointsXYZ(*outs)
