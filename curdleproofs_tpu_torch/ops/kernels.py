"""The hand-written CUDA kernels of the MSM path, their wrappers, and beside
each its plain PyTorch version.

Kernels (sources in `../csrc/`, one shared object each):
- `fq_mul`             batched Montgomery product          (fq_mul.cu)
- `g1_add`             complete projective add             (g1_add.cu)
- `g1_fold_madd`       Pippenger bucket fold, mixed adds   (g1_fold_madd.cu)
- `g1_suffix_weighted` bucket-reduction inner step         (g1_suffix_weighted.cu)
- `g1_fold_packed`     Pippenger bucket fold, full adds    (g1_fold_packed.cu)
- `g1_sqrt`            y from x, compressed base ingest    (g1_sqrt.cu)

Each wrapper takes the reference layouts as int32 tensors (16-bit limbs
`[24, ...]`, packed limb pairs `[12, ...]`; the kernels read them as
uint32).  For a tensor on the CPU it runs the plain version; for a CUDA
tensor it launches the kernel, or raises.  `LAUNCHES` counts kernel launches
per wrapper, so a run can show its main path went through the kernels.

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
import shutil
import subprocess
import threading

import torch

from ..constants import CURVE_B, Q
from .field import FQ, limb_col, mul_rows, unpack_pairs
from .g1_ops import PointsXYZ, g1_add64, g1_infinity64, g1_madd64
from .limbs import FQ_LIMBS as L

__all__ = ["KERNELS", "LAUNCHES", "SQRT_DIGITS", "build", "reset_launches",
           "fq_mul", "fq_mul_plain", "g1_add", "g1_add_plain",
           "g1_fold_madd", "g1_fold_madd_plain",
           "g1_fold_packed", "g1_fold_packed_plain",
           "g1_suffix_weighted", "g1_suffix_weighted_plain",
           "g1_sqrt", "g1_sqrt_plain"]

KERNELS = ("fq_mul", "g1_add", "g1_fold_madd", "g1_suffix_weighted",
           "g1_fold_packed", "g1_sqrt")
LAUNCHES = {k: 0 for k in KERNELS}
_LAUNCHES_LOCK = threading.Lock()  # a stream's worker thread launches too

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parent / "_build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "fq_mul": [_P, _P, _P, _I64, _P],
    "g1_add": [_P] * 9 + [_I64, _P],
    "g1_fold_madd": [_P, _P, _P, _P, _I64, ctypes.c_int, _I64, _P, _P, _P, _P],
    "g1_suffix_weighted": [_P, _P, _P, ctypes.c_int, _I64] + [_P] * 7,
    "g1_fold_packed": [_P, _P, _P, _P, _I64, ctypes.c_int, _I64, _P, _P, _P, _P],
    "g1_sqrt": [_P, _I64, _P, _P],
}


def _sqrt_digits() -> tuple[int, ...]:
    """(q+1)/4 as MSB-first 2-bit digits for the windowed powering chain."""
    e = (Q + 1) // 4
    nb = e.bit_length()
    nb += nb & 1
    return tuple((e >> (nb - 2 * (j + 1))) & 3 for j in range(nb // 2))


SQRT_DIGITS = _sqrt_digits()


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


def _write_constants() -> None:
    """`sqrt_constants.h` for g1_sqrt.cuh, from the port's constants."""
    digits = ", ".join(map(str, SQRT_DIGITS))
    (BUILD_DIR / "sqrt_constants.h").write_text(f"""\
// generated by curdleproofs_tpu_torch/ops/kernels.py; do not edit
#pragma once
#include <stdint.h>
namespace cp {{
// b = {CURVE_B} in Montgomery form (R = 2^384), 12 x 32-bit limbs
__constant__ const uint32_t B_MONT[12] = {{{_u32s(FQ.to_mont(CURVE_B), 12)}}};
// (q+1)/4 as two-bit digits, most significant first
constexpr int SQRT_NDIGITS = {len(SQRT_DIGITS)};
__constant__ const uint8_t SQRT_DIGITS[SQRT_NDIGITS] = {{{digits}}};
}}  // namespace cp
""")


def build(force: bool = False) -> dict[str, str]:
    """Compile every stale kernel, one nvcc per source, all in parallel.
    Returns each built kernel's ptxas report (registers, spills); raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports: dict[str, str] = {}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [k for k in KERNELS if force or not _fresh(k)]
        nvcc = _nvcc() if todo else ""
        _write_constants()
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


@functools.cache
def _lib(name: str):
    if not _fresh(name):
        build()
    fn = getattr(ctypes.CDLL(str(_so(name))), f"cp_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _lib(name)
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
    if _on_cpu(a, b):
        return fq_mul_plain(a, b)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand(L, *batch).reshape(L, -1).contiguous()
    b = b.expand(L, *batch).reshape(L, -1).contiguous()
    n = a.shape[1]
    out = torch.empty_like(a)
    if n:
        _launch("fq_mul", a.device, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), n)
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
    """Launch either fold kernel (they share one interface)."""
    n_ext = ext_px.shape[1]
    if ext_px.shape != (L // 2, n_ext) or ext_py.shape != ext_px.shape \
            or ext_zb.shape != (n_ext,) or plan.ndim != 2:
        raise ValueError("fold takes [12, E] pairs, [E] bits and a [T, S] plan")
    ext_px, ext_py, ext_zb, plan = (t.contiguous() for t in
                                    (ext_px, ext_py, ext_zb, plan))
    t_rows, s_pad = plan.shape
    outs = [torch.empty((L, s_pad), dtype=torch.int32, device=plan.device)
            for _ in range(3)]
    if s_pad:
        _launch(name, plan.device,
                *(t.data_ptr() for t in (ext_px, ext_py, ext_zb, plan)),
                n_ext, t_rows, s_pad, *(t.data_ptr() for t in outs))
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


def g1_suffix_weighted(x, y, z) -> tuple[PointsXYZ, PointsXYZ]:
    if _on_cpu(x, y, z):
        return g1_suffix_weighted_plain(x, y, z)
    if x.ndim != 3 or x.shape[0] != L or y.shape != x.shape \
            or z.shape != x.shape:
        raise ValueError("suffix takes three [24, Cb, WG] limb tensors")
    x, y, z = (t.contiguous() for t in (x, y, z))
    cb, wg = x.shape[1], x.shape[2]
    outs = [torch.empty((L, wg), dtype=torch.int32, device=x.device)
            for _ in range(6)]
    if wg:
        _launch("g1_suffix_weighted", x.device,
                *(t.data_ptr() for t in (x, y, z)), cb, wg,
                *(t.data_ptr() for t in outs))
    return PointsXYZ(*outs[:3]), PointsXYZ(*outs[3:])


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
