"""Build the native host library (g++ -O3 shared object) with generated constants.

The library and its generated constants header go into the package's
`_build/native/` directory (not committed); the first use in a checkout
compiles it, and an exclusive file lock keeps concurrent processes (test
workers) from compiling it twice.
"""

from __future__ import annotations

import fcntl
import os
import pathlib
import subprocess

try:
    from ...constants import Q, R
except ImportError:  # direct script invocation: python build.py
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parents[3]))
    from curdleproofs_tpu_torch.constants import Q, R

_DIR = pathlib.Path(__file__).parent
BUILD_DIR = _DIR.parents[1] / "_build" / "native"
_SO = BUILD_DIR / "libcurdleproofs_native.so"


def _limbs64(x: int, n: int) -> str:
    out = []
    for _ in range(n):
        out.append(f"0x{x & ((1 << 64) - 1):016x}ULL")
        x >>= 64
    return ", ".join(out)


def _limbs52(x: int, n: int = 8) -> str:
    out = []
    for _ in range(n):
        out.append(f"0x{x & ((1 << 52) - 1):013x}ULL")
        x >>= 52
    return ", ".join(out)


def _write_constants() -> None:
    r = 1 << 384
    r2 = r * r % Q
    one_mont = r % Q
    p_inv64 = (-pow(Q, -1, 1 << 64)) % (1 << 64)
    # radix-2^52 (AVX512-IFMA) Montgomery domain: R52 = 2^416
    p_inv52 = (-pow(Q, -1, 1 << 52)) % (1 << 52)
    conv_in52 = (1 << 448) % Q    # mont52_mul(x*2^384, this) = x*2^416
    conv_out52 = (1 << 384) % Q   # mont52_mul(x*2^416, this) = x*2^384
    one_mont52 = (1 << 416) % Q
    beta = 0x5f19672fdf76ce51ba69c6076a0f77eaddb3a93be6f89688de17d813620a00022e01fffffffefffe
    assert pow(beta, 3, Q) == 1 and beta != 1
    (BUILD_DIR / "constants_generated.h").write_text(f"""\
// generated by build.py — do not edit
static const u64 P[6] = {{{_limbs64(Q, 6)}}};
static const u64 P_INV64 = 0x{p_inv64:016x}ULL;
static const u64 R2[6] = {{{_limbs64(r2, 6)}}};
static const u64 ONE_MONT[6] = {{{_limbs64(one_mont, 6)}}};
// radix-2^52 limbs (8 limbs, little-endian) for the IFMA engine
static const u64 P52[8] = {{{_limbs52(Q)}}};
static const u64 P_INV52 = 0x{p_inv52:013x}ULL;
static const u64 CONV_IN52[8] = {{{_limbs52(conv_in52)}}};
static const u64 CONV_OUT52[8] = {{{_limbs52(conv_out52)}}};
static const u64 ONE_MONT52[8] = {{{_limbs52(one_mont52)}}};
// (q+1)/4 — the Tonelli exponent for q = 3 mod 4 square roots
static const u64 Q14[6] = {{{_limbs64((Q + 1) // 4, 6)}}};
// the scalar-field order r (for [r]P subgroup checks)
static const u64 R_ORDER[4] = {{{_limbs64(R, 4)}}};
// Fr Montgomery domain (radix 2^64, R_fr = 2^256): verifier scalar chains
static const u64 FR_INV64 = 0x{(-pow(R, -1, 1 << 64)) % (1 << 64):016x}ULL;
static const u64 FR_R2[4] = {{{_limbs64((1 << 256) ** 2 % R, 4)}}};
static const u64 FR_ONE_MONT[4] = {{{_limbs64((1 << 256) % R, 4)}}};
// GLV endomorphism beta: the cube root of unity in Fq for which
// (beta*x, y) = lambda*(x, y) on G1 with lambda = -z^2 mod r (z the BLS
// parameter); value validated against host/glv.py's derivation by tests.
// Powers the endomorphism subgroup check phi(P) + z^2*P == O.
static const u64 BETA_MONT[6] = {{{_limbs64(beta * (1 << 384) % Q, 6)}}};
static const u64 BETA_MONT52[8] = {{{_limbs52(beta * (1 << 416) % Q)}}};
""")


def _fresh() -> bool:
    newest = max((_DIR / f).stat().st_mtime
                 for f in ("bls12_381.cpp", "ifma52.h", "build.py"))
    return _SO.exists() and _SO.stat().st_mtime > newest


def build(force: bool = False) -> pathlib.Path | None:
    """Compile the shared object; returns its path or None on failure."""
    if _fresh() and not force:
        return _SO
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh() and not force:  # another process built it meanwhile
            return _SO
        _write_constants()
        # build to a temp path and rename: overwriting the .so in place would
        # truncate the file under any RUNNING process that has it mapped
        tmp = _SO.with_suffix(f".so.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-march=native", "-funroll-loops", "-shared",
               "-fPIC", "-pthread", "-I", str(BUILD_DIR), "-o", str(tmp),
               str(_DIR / "bls12_381.cpp")]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            tmp.replace(_SO)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            return None
    return _SO


if __name__ == "__main__":
    path = build(force=True)
    print(f"built: {path}")
