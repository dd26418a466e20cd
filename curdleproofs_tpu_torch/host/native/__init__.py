"""ctypes bindings for the native host runtime (C++ 64-bit-limb BLS12-381).

Falls back gracefully: `lib()` returns None when g++ or the build is
unavailable and callers keep using the pure-Python path.
"""

from __future__ import annotations

import ctypes
import functools

from ...constants import Q, R
from ..g1 import G1

_POINT = 144  # jacobian canonical LE: x, y, z @ 48 bytes
_SCALAR = 32


@functools.cache
def lib() -> ctypes.CDLL | None:
    from .build import build

    path = build()
    if path is None:
        return None
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in {
        "cp_msm": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                   ctypes.c_char_p],
        "cp_add": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p],
        "cp_mul": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p],
        "cp_batch_mul": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                         ctypes.c_char_p],
        "cp_batch_mul_each": [ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_uint64, ctypes.c_char_p],
        "cp_fold": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                    ctypes.c_char_p, ctypes.c_char_p],
        "cp_keccak_f1600": [ctypes.c_char_p],
        "cp_mul_raw": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                       ctypes.c_char_p],
        "cp_dual_mul": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
                        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_char_p],
        "cp_dual_mul_each": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p],
        "cp_fold_each": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                         ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                         ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
                         ctypes.c_char_p],
        "cp_dual_mul_norm": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                             ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
                             ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
                             ctypes.c_char_p],
        "cp_batch_normalize": [ctypes.c_char_p, ctypes.c_uint64],
        "cp_export_mont_affine": [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p],
        "cp_export_mont_x": [ctypes.c_char_p, ctypes.c_uint64,
                             ctypes.c_char_p, ctypes.c_char_p],
        "cp_fr_vsp": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                      ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
                      ctypes.c_char_p],
        "cp_fr_powers": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p],
        "cp_fr_scale_vec": [ctypes.c_char_p, ctypes.c_char_p,
                            ctypes.c_uint64, ctypes.c_char_p],
        "cp_fr_scale_accum": [ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_uint64,
                              ctypes.c_char_p],
        "cp_fr_outer": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                        ctypes.c_uint64, ctypes.c_char_p],
        "cp_fr_axpy": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_uint64, ctypes.c_char_p],
        "cp_fr_mul_vec": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                          ctypes.c_char_p],
        "cp_fr_inner_many": [ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_uint64, ctypes.c_uint64,
                             ctypes.c_char_p],
        "cp_fr_prefix_prod": [ctypes.c_char_p, ctypes.c_uint64,
                              ctypes.c_char_p],
        "cp_msm_ba": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                      ctypes.c_char_p],
        "cp_msm_glv": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                       ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_char_p, ctypes.c_char_p],
        "cp_msm_glv_many": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
                            ctypes.c_uint64, ctypes.c_char_p],
        "cp_strobe_init": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64],
        "cp_transcript_challenges": [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_uint64,
                                     ctypes.c_char_p],
        "cp_strobe_meta_ad": [ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_uint64, ctypes.c_int32],
        "cp_strobe_ad": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                         ctypes.c_int32],
        "cp_strobe_prf": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                          ctypes.c_int32],
        "cp_strobe_append_many": [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_uint64],
        "cp_g1_decompress_validate": [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_uint64],
        "cp_subgroup_check": [ctypes.c_char_p, ctypes.c_uint64,
                              ctypes.c_char_p, ctypes.c_uint64],
        "cp_same_msm_prove_loop": [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_uint64, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p],
        "cp_ipa_prove_loop": [ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_uint64,
                              ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_char_p],
    }.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = None
    cdll.cp_same_msm_prove_loop.restype = ctypes.c_int32
    cdll.cp_ipa_prove_loop.restype = ctypes.c_int32
    cdll.cp_glv_decompose.restype = ctypes.c_int32
    cdll.cp_g1_decompress_validate.restype = ctypes.c_uint32
    cdll.cp_subgroup_check.restype = ctypes.c_uint32
    return cdll


def available() -> bool:
    return lib() is not None


# --- codecs -----------------------------------------------------------------

def _pt_to_bytes(p: G1) -> bytes:
    nb = p._nb
    if nb is None:
        nb = (p.x % Q).to_bytes(48, "little") \
            + (p.y % Q).to_bytes(48, "little") \
            + (p.z % Q).to_bytes(48, "little")
        p._nb = nb
    return nb


def pts_to_bytes(pts: list[G1]) -> bytes:
    return b"".join(_pt_to_bytes(p) for p in pts)


def scalars_to_bytes(ss: list[int]) -> bytes:
    return b"".join((s % R).to_bytes(32, "little") for s in ss)


def pts_from_bytes(buf: bytes, n: int) -> list[G1]:
    out = []
    for i in range(n):
        o = i * _POINT
        x = int.from_bytes(buf[o : o + 48], "little")
        y = int.from_bytes(buf[o + 48 : o + 96], "little")
        z = int.from_bytes(buf[o + 96 : o + 144], "little")
        out.append(G1.infinity() if z == 0 else G1(x, y, z))
    return out


# --- high-level wrappers -------------------------------------------------------

_GLV = None


def _glv():
    global _GLV
    if _GLV is None:
        from .. import glv as _g

        _GLV = _g
    return _GLV


def _dual_args(scalar: int):
    g = _glv()
    k1, k2 = g.decompose(scalar % R)
    nbits = max(abs(k1).bit_length(), abs(k2).bit_length(), 1)
    return (abs(k1).to_bytes(32, "little"), 1 if k1 < 0 else 0,
            abs(k2).to_bytes(32, "little"), 1 if k2 < 0 else 0, nbits,
            (g.BETA).to_bytes(48, "little"))


def mul_glv(p: G1, scalar: int) -> G1:
    """k*P via the GLV dual-scalar path (~1.7x the plain ladder)."""
    k1b, n1, k2b, n2, nbits, beta = _dual_args(scalar)
    out = ctypes.create_string_buffer(_POINT)
    lib().cp_dual_mul(None, _pt_to_bytes(p), 1, beta, k1b, n1, k2b, n2,
                      nbits, out)
    return pts_from_bytes(out.raw, 1)[0]


def batch_to_affine(points: list[G1]) -> list[tuple[int, int] | None]:
    """Affine (x, y) per point (None for infinity) via ONE native inversion."""
    n = len(points)
    buf = ctypes.create_string_buffer(pts_to_bytes(points), _POINT * n)
    lib().cp_batch_normalize(buf, n)
    raw = buf.raw
    out: list[tuple[int, int] | None] = []
    for i in range(n):
        o = i * _POINT
        if raw[o + 96 : o + 144] == b"\x00" * 48:
            out.append(None)
        else:
            out.append((int.from_bytes(raw[o : o + 48], "little"),
                        int.from_bytes(raw[o + 48 : o + 96], "little")))
    return out


def export_mont_affine(points: list[G1], n_pad: int):
    """Affine Montgomery limbs for the device upload path.

    Returns (px, py, zb): px/py are [12, n_pad] uint32 packed 16-bit limb
    PAIRS of the Montgomery residues (the device MSM's resident layout,
    ops/msm_device.py `_pack_rows`), zb a [n_pad] uint32 liveness bit.
    Padding columns are the identity's representation (x=0, y=1_mont, zb=0).
    Host R = 2^384 = the device Montgomery radix, so no form change anywhere.
    """
    import numpy as np

    n = len(points)
    ox = ctypes.create_string_buffer(48 * n)
    oy = ctypes.create_string_buffer(48 * n)
    ozb = ctypes.create_string_buffer(n)
    lib().cp_export_mont_affine(pts_to_bytes(points), n, ox, oy, ozb)

    def pack(buf, pad_value: int) -> np.ndarray:
        a = np.frombuffer(buf.raw, dtype="<u2").reshape(n, 24)
        out = np.empty((12, n_pad), dtype=np.uint32)
        lo = a[:, 0::2].astype(np.uint32)
        hi = a[:, 1::2].astype(np.uint32)
        out[:, :n] = (lo | (hi << 16)).T
        if n_pad > n:
            pv = np.empty(12, dtype=np.uint32)
            for i in range(12):
                pv[i] = pad_value & 0xFFFFFFFF
                pad_value >>= 32
            out[:, n:] = pv[:, None]
        return out

    one_mont = (1 << 384) % Q
    zb = np.zeros(n_pad, dtype=np.uint32)
    zb[:n] = np.frombuffer(ozb.raw, dtype=np.uint8)
    return pack(ox, 0), pack(oy, one_mont), zb


def fr_vsp(challenges: list[int], n: int, cmul: int | None = None,
           mulvec: list[int] | None = None, neg: bool = False,
           raw: bool = False):
    """Verification-scalar products with optional constant/vector scaling and
    negation, whole chain native (one Montgomery mul per entry).  `raw=True`
    returns the canonical 32 B-LE buffer for FrVec accumulation."""
    logn = len(challenges)
    ch = b"".join(c.to_bytes(32, "little") for c in challenges)
    cm = cmul.to_bytes(32, "little") if cmul is not None else None
    mv = (b"".join(v.to_bytes(32, "little") for v in mulvec)
          if mulvec is not None else None)
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_vsp(ch, logn, n, cm, mv, 1 if neg else 0, out)
    if raw:
        return out.raw[: 32 * n]
    raw_b = out.raw
    return [int.from_bytes(raw_b[i * 32:(i + 1) * 32], "little")
            for i in range(n)]


def fr_powers(base: int, n: int) -> list[int]:
    """[base^1, ..., base^n] canonical, native."""
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_powers(base.to_bytes(32, "little"), n, out)
    raw = out.raw
    return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
            for i in range(n)]


def fr_outer_raw(a: bytes, b: bytes) -> bytes:
    """Outer product out[i*nb+j] = a[i]*b[j] mod r over canonical 32 B-LE
    buffers — the composite-scalar expansion of one batched-prover relation
    (witness half x gamma-weight vector)."""
    na, nb = len(a) // 32, len(b) // 32
    out = ctypes.create_string_buffer(32 * na * nb)
    lib().cp_fr_outer(bytes(a), na, bytes(b), nb, out)
    return out.raw


def fr_axpy_raw(gamma: int, x: bytes, y: bytes) -> bytes:
    """out[i] = x[i] + gamma * y[i] mod r over canonical 32 B-LE buffers —
    one folding-round witness update."""
    n = len(x) // 32
    assert len(y) == len(x)
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_axpy(gamma.to_bytes(32, "little"), bytes(x), bytes(y), n, out)
    return out.raw


def fr_mul_vec_raw(a: bytes, b: bytes) -> bytes:
    """Elementwise out[i] = a[i]*b[i] mod r over canonical 32 B-LE buffers."""
    n = len(a) // 32
    assert len(b) == len(a)
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_mul_vec(bytes(a), bytes(b), n, out)
    return out.raw


def fr_inner_many_raw(a: bytes, b: bytes, n: int) -> list[int]:
    """m = len(a)/32/n inner products of length n over contiguous canonical
    32 B-LE blocks: out[k] = <a[k], b[k]> mod r."""
    m = len(a) // 32 // n
    assert len(a) == len(b) == 32 * n * m
    out = ctypes.create_string_buffer(32 * m)
    lib().cp_fr_inner_many(bytes(a), bytes(b), n, m, out)
    raw = out.raw
    return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
            for i in range(m)]


def fr_prefix_prod_raw(xs: bytes) -> bytes:
    """Exclusive prefix products [1, x0, x0*x1, ...] mod r (canonical LE)."""
    n = len(xs) // 32
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_prefix_prod(bytes(xs), n, out)
    return out.raw


def fr_scale_raw(rf: int, xs: bytes) -> bytes:
    """Raw twin of `fr_scale`: canonical 32 B-LE in and out."""
    n = len(xs) // 32
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_scale_vec(rf.to_bytes(32, "little"), bytes(xs), n, out)
    return out.raw


def fr_powers_raw(base: int, n: int) -> bytes:
    """Raw twin of `fr_powers`: [base^1..base^n] as canonical 32 B-LE."""
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_powers(base.to_bytes(32, "little"), n, out)
    return out.raw


def fr_scale(rf: int, xs: list[int]) -> list[int]:
    """[rf * x mod r for x in xs], one native Montgomery mul per element."""
    n = len(xs)
    buf = b"".join(x.to_bytes(32, "little") for x in xs)
    out = ctypes.create_string_buffer(32 * n)
    lib().cp_fr_scale_vec(rf.to_bytes(32, "little"), buf, n, out)
    raw = out.raw
    return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
            for i in range(n)]


def fr_scale_accum(jobs, nkeys: int, raw: bool = False):
    """Fused verifier dedup: for every job (rf, xs, keys) do
    acc[keys[i]] += rf * xs[i] mod r, over a shared accumulator of `nkeys`
    scalars; returns the merged scalars. One native sweep per relation —
    replaces the per-entry python dict merge on the batch-verify hot path.

    `raw=True` returns the accumulator as canonical 32 B-LE bytes (the
    layout `msm_scalars_raw`/`cp_glv_decompose` consume), skipping the
    per-key int materialisation on the verify path entirely."""
    acc = ctypes.create_string_buffer(32 * max(nkeys, 1))
    L = lib()
    for rf, xs, keys in jobs:
        if isinstance(xs, (bytes, bytearray)):  # pre-serialised (FrVec.to_raw)
            buf, cnt = bytes(xs), len(xs) // 32
        else:
            buf = b"".join(
                (x if 0 <= x < R else x % R)
                .to_bytes(32, "little") for x in xs)
            cnt = len(xs)
        L.cp_fr_scale_accum(rf.to_bytes(32, "little"), buf, keys.tobytes(),
                            cnt, acc)
    raw_bytes = acc.raw[: 32 * nkeys]
    if raw:
        return raw_bytes
    return [int.from_bytes(raw_bytes[i * 32:(i + 1) * 32], "little")
            for i in range(nkeys)]


def export_mont_x(points: list[G1], n_pad: int):
    """Compressed twin of `export_mont_affine`: (px, meta) where px is the
    [12, n_pad] packed Montgomery x limb pairs and meta a [n_pad] uint32 of
    `liveness | (canonical_y_parity << 1)` — 49 B/point over the link; the
    device reconstructs y via the sqrt kernel.  Padding columns are the
    identity (x=0, meta=0)."""
    import numpy as np

    n = len(points)
    ox = ctypes.create_string_buffer(48 * n)
    om = ctypes.create_string_buffer(n)
    lib().cp_export_mont_x(pts_to_bytes(points), n, ox, om)

    a = np.frombuffer(ox.raw, dtype="<u2").reshape(n, 24)
    px = np.zeros((12, n_pad), dtype=np.uint32)
    px[:, :n] = (a[:, 0::2].astype(np.uint32)
                 | (a[:, 1::2].astype(np.uint32) << 16)).T
    meta = np.zeros(n_pad, dtype=np.uint32)
    meta[:n] = np.frombuffer(om.raw, dtype=np.uint8)
    return px, meta


def batch_mul_glv(points: list[G1], scalar: int) -> list[G1]:
    n = len(points)
    k1b, n1, k2b, n2, nbits, beta = _dual_args(scalar)
    out = ctypes.create_string_buffer(_POINT * n)
    lib().cp_dual_mul_norm(None, pts_to_bytes(points), n, beta, k1b, n1,
                           k2b, n2, nbits, out)
    return pts_from_bytes(out.raw, n)


def fold_glv(left: list[G1], right: list[G1], gamma: int) -> list[G1]:
    """Fold with batch-normalised output (z=1), so downstream table adds and
    MSM bucket adds take the mixed-addition fast path."""
    n = len(left)
    k1b, n1, k2b, n2, nbits, beta = _dual_args(gamma)
    out = ctypes.create_string_buffer(_POINT * n)
    lib().cp_dual_mul_norm(pts_to_bytes(left), pts_to_bytes(right), n, beta,
                           k1b, n1, k2b, n2, nbits, out)
    return pts_from_bytes(out.raw, n)


def fold_each_glv(left: list[G1], right: list[G1],
                  scalars: list[int]) -> list[G1]:
    """[left_i + s_i * right_i] with per-point scalars (e.g. the IPA round's
    gamma/gamma_inv fold pair concatenated into one call)."""
    g = _glv()
    n = len(right)
    db = g.decompose_batch(scalars)
    if db is None:
        return [l.add(r.mul(s)) for l, r, s in zip(left, right, scalars)]
    hk1, negs1, hk2, negs2 = db
    pad = b"\x00" * 16
    k1s = b"".join(hk1[16 * i : 16 * i + 16] + pad for i in range(n))
    k2s = b"".join(hk2[16 * i : 16 * i + 16] + pad for i in range(n))
    out = ctypes.create_string_buffer(_POINT * n)
    lib().cp_fold_each(pts_to_bytes(left), pts_to_bytes(right), n,
                       g.BETA.to_bytes(48, "little"),
                       k1s, negs1, k2s, negs2, 128, out)
    return pts_from_bytes(out.raw, n)


def batch_mul_each_glv(points: list[G1], scalars: list[int]) -> list[G1]:
    g = _glv()
    n = len(points)
    db = g.decompose_batch(scalars)
    if db is not None:
        hk1, negs1, hk2, negs2 = db
        pad = b"\x00" * 16  # cp_dual_mul_each takes 32-byte scalar entries
        k1s = b"".join(hk1[16 * i : 16 * i + 16] + pad for i in range(n))
        k2s = b"".join(hk2[16 * i : 16 * i + 16] + pad for i in range(n))
        nbits = 128
    else:
        k1b, n1b, k2b, n2b = bytearray(), bytearray(), bytearray(), bytearray()
        nbits = 1
        for s in scalars:
            k1, k2 = g.decompose(s % R)
            nbits = max(nbits, abs(k1).bit_length(), abs(k2).bit_length())
            k1b += abs(k1).to_bytes(32, "little")
            k2b += abs(k2).to_bytes(32, "little")
            n1b.append(1 if k1 < 0 else 0)
            n2b.append(1 if k2 < 0 else 0)
        k1s, negs1, k2s, negs2 = bytes(k1b), bytes(n1b), bytes(k2b), bytes(n2b)
    out = ctypes.create_string_buffer(_POINT * n)
    lib().cp_dual_mul_each(pts_to_bytes(points), n,
                           g.BETA.to_bytes(48, "little"),
                           k1s, negs1, k2s, negs2, nbits, out)
    return pts_from_bytes(out.raw, n)


MSM_GLV_CUTOFF = 32


def msm(points: list[G1], scalars: list[int]) -> G1:
    """GLV + signed-digit + batch-affine Pippenger above the Straus cutoff
    (cp_msm_glv); plain Straus/Pippenger (cp_msm) below it."""
    l = lib()
    out = ctypes.create_string_buffer(_POINT)
    n = len(points)
    if n < MSM_GLV_CUTOFF:
        l.cp_msm(pts_to_bytes(points), scalars_to_bytes(scalars), n, out)
        return pts_from_bytes(out.raw, 1)[0]
    g = _glv()
    db = g.decompose_batch(scalars)
    if db is None:
        k1s, k2s = bytearray(), bytearray()
        negs1, negs2 = bytearray(), bytearray()
        try:
            for s in scalars:
                k1, k2 = g.decompose(s % R)
                k1s += abs(k1).to_bytes(16, "little")  # raises if >= 2^128
                k2s += abs(k2).to_bytes(16, "little")
                negs1.append(1 if k1 < 0 else 0)
                negs2.append(1 if k2 < 0 else 0)
        except OverflowError:  # oversized GLV half (shouldn't happen)
            l.cp_msm(pts_to_bytes(points), scalars_to_bytes(scalars), n, out)
            return pts_from_bytes(out.raw, 1)[0]
        db = (bytes(k1s), bytes(negs1), bytes(k2s), bytes(negs2))
    k1s, negs1, k2s, negs2 = db
    l.cp_msm_glv(pts_to_bytes(points), n, k1s, negs1, k2s, negs2,
                 g.BETA.to_bytes(48, "little"), out)
    return pts_from_bytes(out.raw, 1)[0]


def msm_scalars_raw(points: list[G1], sbytes: bytes) -> G1:
    """`msm` with scalars given as canonical 32 B-LE raw bytes.

    The verifier's fused dedup (`fr_scale_accum(raw=True)`) produces exactly
    this layout, so the accumulated-MSM check runs dedup -> GLV split -> MSM
    without ever materialising the ~|bases| merged scalars as python ints."""
    l = lib()
    out = ctypes.create_string_buffer(_POINT)
    n = len(points)
    if len(sbytes) != 32 * n:  # hard raise: short buffer = zero scalars =
        # the accumulated-MSM check failing OPEN (asserts vanish under -O)
        raise ValueError(f"scalar buffer is {len(sbytes)} B for {n} points")
    if n == 0:
        return G1.infinity()
    if n < MSM_GLV_CUTOFF:
        l.cp_msm(pts_to_bytes(points), sbytes, n, out)
        return pts_from_bytes(out.raw, 1)[0]
    g = _glv()
    db = g.decompose_batch_raw(sbytes, n)
    if db is None:  # native GLV unavailable: one conversion pass, slow path
        return msm(points, [int.from_bytes(sbytes[i * 32:(i + 1) * 32],
                                           "little") for i in range(n)])
    k1s, negs1, k2s, negs2 = db
    l.cp_msm_glv(pts_to_bytes(points), n, k1s, negs1, k2s, negs2,
                 g.BETA.to_bytes(48, "little"), out)
    return pts_from_bytes(out.raw, 1)[0]


def msm_many(groups: list[tuple[list[G1], list[int]]]) -> list[G1]:
    """Independent MSMs sharing one native bucket tree (amortizes the fixed
    per-call costs; the protocol's folding rounds issue 4-6 same-size MSMs)."""
    l = lib()
    g = _glv()
    pts_all: list[G1] = []
    ss_all: list[int] = []
    mids = []
    for mi, (pts, ss) in enumerate(groups):
        pts_all.extend(pts)
        ss_all.extend(ss)
        mids.extend([mi] * len(pts))
    n = len(pts_all)
    if n == 0:
        return [G1.infinity() for _ in groups]
    db = g.decompose_batch(ss_all)
    if db is None:
        k1s, k2s = bytearray(), bytearray()
        negs1, negs2 = bytearray(), bytearray()
        try:
            for s in ss_all:
                k1, k2 = g.decompose(s % R)
                k1s += abs(k1).to_bytes(16, "little")
                k2s += abs(k2).to_bytes(16, "little")
                negs1.append(1 if k1 < 0 else 0)
                negs2.append(1 if k2 < 0 else 0)
        except OverflowError:
            return [msm(pts, ss) for pts, ss in groups]
        db = (bytes(k1s), bytes(negs1), bytes(k2s), bytes(negs2))
    k1s, negs1, k2s, negs2 = db
    mid_arr = (ctypes.c_uint32 * n)(*mids)
    out = ctypes.create_string_buffer(_POINT * len(groups))
    l.cp_msm_glv_many(pts_to_bytes(pts_all), n, k1s, negs1, k2s, negs2,
                      g.BETA.to_bytes(48, "little"),
                      mid_arr, len(groups), out)
    return pts_from_bytes(out.raw, len(groups))


def mul(p: G1, scalar: int) -> G1:
    l = lib()
    out = ctypes.create_string_buffer(_POINT)
    l.cp_mul(_pt_to_bytes(p), (scalar % R).to_bytes(32, "little"), out)
    return pts_from_bytes(out.raw, 1)[0]


def add(p: G1, q: G1) -> G1:
    l = lib()
    out = ctypes.create_string_buffer(_POINT)
    l.cp_add(_pt_to_bytes(p), _pt_to_bytes(q), out)
    return pts_from_bytes(out.raw, 1)[0]


def batch_mul(points: list[G1], scalar: int) -> list[G1]:
    l = lib()
    n = len(points)
    out = ctypes.create_string_buffer(_POINT * n)
    l.cp_batch_mul(pts_to_bytes(points), n,
                   (scalar % R).to_bytes(32, "little"), out)
    return pts_from_bytes(out.raw, n)


def batch_mul_each(points: list[G1], scalars: list[int]) -> list[G1]:
    l = lib()
    n = len(points)
    out = ctypes.create_string_buffer(_POINT * n)
    l.cp_batch_mul_each(pts_to_bytes(points), scalars_to_bytes(scalars), n, out)
    return pts_from_bytes(out.raw, n)


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state."""
    buf = ctypes.create_string_buffer(bytes(state), 200)
    lib().cp_keccak_f1600(buf)
    state[:] = buf.raw[:200]


def mul_raw(p: G1, scalar: int) -> G1:
    """Unreduced scalar mul (cofactor clearing, subgroup checks)."""
    nbytes = max(1, (scalar.bit_length() + 7) // 8)
    out = ctypes.create_string_buffer(_POINT)
    l = lib()
    l.cp_mul_raw(_pt_to_bytes(p), scalar.to_bytes(nbytes, "little"), nbytes, out)
    return pts_from_bytes(out.raw, 1)[0]


def fold(left: list[G1], right: list[G1], gamma: int) -> list[G1]:
    l = lib()
    n = len(left)
    out = ctypes.create_string_buffer(_POINT * n)
    l.cp_fold(pts_to_bytes(left), pts_to_bytes(right), n,
              (gamma % R).to_bytes(32, "little"), out)
    return pts_from_bytes(out.raw, n)


# --- native prover round loops -----------------------------------------------

def same_msm_prove_loop(strobe_blob, vec_G: list[G1], vec_T: list[G1],
                        vec_U: list[G1], vec_x: list[int]):
    """Run the SameMsm folding recursion natively (one call for all rounds).

    Returns (vec_L_A, vec_L_T, vec_L_U, vec_R_A, vec_R_T, vec_R_U, x_final)
    or None when the native path is unavailable (caller falls back to the
    bit-identical Python loop). `strobe_blob` is the live transcript state —
    it advances exactly as the Python loop would."""
    l = lib()
    if l is None or not hasattr(l, "cp_same_msm_prove_loop"):
        return None
    g = _glv()
    if g._native_glv() is None:  # the loop decomposes natively (cp_glv_init)
        return None
    n = len(vec_x)
    if n < 4 or n & (n - 1):
        return None
    lg_n = n.bit_length() - 1
    pts = pts_to_bytes(vec_G) + pts_to_bytes(vec_T) + pts_to_bytes(vec_U)
    out_lr = ctypes.create_string_buffer(6 * lg_n * _POINT)
    x_final = ctypes.create_string_buffer(32)
    rc = l.cp_same_msm_prove_loop(strobe_blob, pts, n,
                                  scalars_to_bytes(vec_x),
                                  g.BETA.to_bytes(48, "little"),
                                  out_lr, x_final)
    if rc != 0:
        return None
    flat = pts_from_bytes(out_lr.raw, 6 * lg_n)
    return (flat[0::6], flat[1::6], flat[2::6], flat[3::6], flat[4::6],
            flat[5::6], int.from_bytes(x_final.raw, "little"))


def ipa_prove_loop(strobe_blob, vec_G: list[G1], vec_G_prime: list[G1],
                   H: G1, vec_c: list[int], vec_d: list[int]):
    """Run the IPA folding recursion natively; the H*<c,d> terms fold into
    each round's shared-bucket MSM. Returns
    (vec_L_C, vec_L_D, vec_R_C, vec_R_D, c_final, d_final) or None."""
    l = lib()
    if l is None or not hasattr(l, "cp_ipa_prove_loop"):
        return None
    g = _glv()
    if g._native_glv() is None:  # the loop decomposes natively (cp_glv_init)
        return None
    n = len(vec_c)
    if n < 4 or n & (n - 1):
        return None
    lg_n = n.bit_length() - 1
    out_lr = ctypes.create_string_buffer(4 * lg_n * _POINT)
    c_final = ctypes.create_string_buffer(32)
    d_final = ctypes.create_string_buffer(32)
    rc = l.cp_ipa_prove_loop(strobe_blob, pts_to_bytes(vec_G),
                             pts_to_bytes(vec_G_prime), n,
                             scalars_to_bytes(vec_c), scalars_to_bytes(vec_d),
                             _pt_to_bytes(H), g.BETA.to_bytes(48, "little"),
                             out_lr, c_final, d_final)
    if rc != 0:
        return None
    flat = pts_from_bytes(out_lr.raw, 4 * lg_n)
    return (flat[0::4], flat[1::4], flat[2::4], flat[3::4],
            int.from_bytes(c_final.raw, "little"),
            int.from_bytes(d_final.raw, "little"))
