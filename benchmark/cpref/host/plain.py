"""ctypes bindings for `plain.c`, the reference's plain arithmetic.

`plain.c` is compiled at first use into
`benchmark/_build/cpref-plain/<the sources' sha256>/` (not committed): a
fixed directory for given sources, so only the first run in a checkout
compiles it; an exclusive file lock keeps concurrent processes from
compiling it twice.  The reference needs it: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import subprocess

from ..constants import Q, R

_DIR = pathlib.Path(__file__).parent
_SOURCES = ("plain.c", "plain.py")
_POINT = 144  # canonical LE x, y, z @ 48 bytes; z = 0 at infinity


def _source_key() -> str:
    h = hashlib.sha256()
    for f in _SOURCES:
        h.update((_DIR / f).read_bytes())
    return h.hexdigest()[:16]


BUILD_DIR = _DIR.parents[1] / "_build" / "cpref-plain" / _source_key()
_SO = BUILD_DIR / "libcpref_plain.so"


def _limbs(x: int) -> str:
    return ", ".join(f"0x{(x >> (64 * i)) & ((1 << 64) - 1):016x}ULL"
                     for i in range(6))


def build() -> pathlib.Path:
    """Compile the shared object (once a checkout); returns its path."""
    if _SO.exists():
        return _SO
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _SO.exists():
            return _SO
        p_inv = (-pow(Q, -1, 1 << 64)) % (1 << 64)
        (BUILD_DIR / "constants.h").write_text(
            "/* generated by plain.py */\n"
            f"static const u64 P[6] = {{{_limbs(Q)}}};\n"
            f"static const u64 P_INV = 0x{p_inv:016x}ULL;\n"
            f"static const u64 R2[6] = {{{_limbs((1 << 768) % Q)}}};\n")
        tmp = _SO.with_suffix(f".so.{os.getpid()}.tmp")
        subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-I", str(BUILD_DIR),
                        "-o", str(tmp), str(_DIR / "plain.c")],
                       check=True, capture_output=True, text=True)
        tmp.replace(_SO)
    return _SO


@functools.cache
def lib() -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(build()))
    p, n = ctypes.c_char_p, ctypes.c_uint64
    for name, args in {"pr_mul_each": [p, p, n, p],
                       "pr_fold_each": [p, p, p, n, p],
                       "pr_msm": [p, p, n, p],
                       "pr_keccak_f1600": [p],
                       "pr_chacha12_four_blocks": [p, n, p]}.items():
        fn = getattr(cdll, name)
        fn.argtypes = args
        fn.restype = None
    return cdll


def _pts(points) -> bytes:
    return b"".join((pt.x % Q).to_bytes(48, "little")
                    + (pt.y % Q).to_bytes(48, "little")
                    + (pt.z % Q).to_bytes(48, "little") for pt in points)


def _scalars(scalars) -> bytes:
    return b"".join((s % R).to_bytes(32, "little") for s in scalars)


def _from(buf: bytes, n: int):
    from .g1 import G1

    out = []
    for i in range(n):
        o = i * _POINT
        z = int.from_bytes(buf[o + 96:o + 144], "little")
        out.append(G1.infinity() if z == 0 else G1(
            int.from_bytes(buf[o:o + 48], "little"),
            int.from_bytes(buf[o + 48:o + 96], "little"), z))
    return out


def msm(points, scalars):
    """sum s_i * P_i"""
    out = ctypes.create_string_buffer(_POINT)
    lib().pr_msm(_pts(points), _scalars(scalars), len(points), out)
    return _from(out.raw, 1)[0]


def mul_each(points, scalars):
    """[s_i * P_i]"""
    n = len(points)
    out = ctypes.create_string_buffer(_POINT * n)
    lib().pr_mul_each(_pts(points), _scalars(scalars), n, out)
    return _from(out.raw, n)


def fold_each(left, right, scalars):
    """[L_i + s_i * R_i]"""
    n = len(left)
    out = ctypes.create_string_buffer(_POINT * n)
    lib().pr_fold_each(_pts(left), _pts(right), _scalars(scalars), n, out)
    return _from(out.raw, n)


def mul_raw(point, scalar: int):
    """scalar * P for any scalar below 2^256 (not reduced mod r)"""
    out = ctypes.create_string_buffer(_POINT)
    lib().pr_mul_each(_pts([point]), scalar.to_bytes(32, "little"), 1, out)
    return _from(out.raw, 1)[0]


def in_subgroup(points) -> list[bool]:
    """[r]P == O for each point: the plain subgroup check."""
    n = len(points)
    out = ctypes.create_string_buffer(_POINT * n)
    order = R.to_bytes(32, "little")
    lib().pr_mul_each(_pts(points), order * n, n, out)
    raw = out.raw
    return [not any(raw[i * _POINT + 96:(i + 1) * _POINT]) for i in range(n)]


def keccak_f1600(state: bytearray) -> None:
    """Keccak-f[1600] in place on a 200-byte state."""
    buf = (ctypes.c_char * 200).from_buffer(state)
    lib().pr_keccak_f1600(ctypes.cast(buf, ctypes.c_char_p))


def chacha12_four_blocks(key_words: list[int], counter: int) -> list[int]:
    key = (ctypes.c_uint32 * 8)(*key_words)
    out = (ctypes.c_uint32 * 64)()
    lib().pr_chacha12_four_blocks(ctypes.cast(key, ctypes.c_char_p), counter,
                                  ctypes.cast(out, ctypes.c_char_p))
    return list(out)
