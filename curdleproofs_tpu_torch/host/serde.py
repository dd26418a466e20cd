"""Byte codecs, bit-exact with arkworks `ark-serialize` 0.4 + `ark-bls12-381` 0.4.

G1 points use the 48-byte ZCash compressed format (flags in the three top bits of
the first byte); Fr uses 32-byte little-endian canonical form. Golden anchors:
generator bytes at `curdleproofs/src/whisk.rs:364-368` and Fr round-trip at
`whisk.rs:354-362`.
"""

from __future__ import annotations

from ..constants import Q, R
from ..utils.trace import count, span
from .g1 import G1, get_ys_from_x

__all__ = [
    "g1_to_bytes", "g1_from_bytes", "fr_to_bytes", "fr_from_bytes",
    "fr_from_le_bytes_mod_order", "fr_from_random_bytes", "vec_len_prefix",
    "SerializationError",
    "g1_from_bytes_batch",
    "deferred_subgroup_checks",
]


class SerializationError(ValueError):
    """A byte encoding the protocol rejects.  `index` is the position of
    the failing point among a `g1_from_bytes_batch` call's, else None."""

    def __init__(self, msg: str, index: int | None = None):
        super().__init__(msg)
        self.index = index


_COMPRESSED_FLAG = 0x80
_INFINITY_FLAG = 0x40
_SORT_FLAG = 0x20  # y is the lexicographically largest of the two roots


def g1_to_bytes(p: G1) -> bytes:
    """ZCash-format compressed serialization (48 bytes, big-endian x).

    Cached on the point object (value-immutable; see G1 docstring) — the
    protocol appends the same R/S/T/U points to the transcript repeatedly."""
    cb = p._cb
    if cb is not None:
        return cb
    aff = p.to_affine()
    if aff is None:
        out = bytearray(48)
        out[0] = _COMPRESSED_FLAG | _INFINITY_FLAG
        cb = bytes(out)
        p._cb = cb
        return cb
    x, y = aff
    out = bytearray(x.to_bytes(48, "big"))
    flags = _COMPRESSED_FLAG
    if y > Q - y:  # y is the larger root (Q - y is the other; y != 0 on this curve)
        flags |= _SORT_FLAG
    out[0] |= flags
    cb = bytes(out)
    p._cb = cb
    return cb


# When set (by `deferred_subgroup_checks`), decompressed (bytes, point)
# pairs queue here and their subgroup membership is verified in ONE batched
# native ladder at context exit — proof deserialization decompresses ~90
# points per proof; a whisk shuffle verify decompresses ~500.
_DEFERRED: list | None = None

# Fully-validated decompression cache: 48-byte compressed encoding -> G1.
# Decompression is a pure function and subgroup membership is a property of
# the bytes, so serving a cached point is sound; entries are inserted ONLY
# after curve + subgroup validation passed.  This is the consensus-client
# access pattern: one round's post-shuffle trackers are the next round's
# pre-trackers, and a verification batch shares its (R, S) inputs across
# proofs — all of which would otherwise pay the ~25 us sqrt + subgroup
# ladder per point again.  Disable with CP_NO_DECOMPRESS_CACHE=1.
_CACHE: dict[bytes, G1] = {}
_CACHE_CAP = 1 << 16  # ~30 MB worst case


def _cache_enabled() -> bool:
    import os

    return os.environ.get("CP_NO_DECOMPRESS_CACHE") != "1"


def _cache_put(buf: bytes, p: G1) -> None:
    if len(_CACHE) >= _CACHE_CAP:
        # evict the oldest 1/16 (insertion order)
        for k in list(__import__("itertools").islice(iter(_CACHE),
                                                     _CACHE_CAP // 16)):
            del _CACHE[k]
    _CACHE[buf] = p


class deferred_subgroup_checks:
    """Context manager batching subgroup checks across many g1_from_bytes."""

    def __enter__(self):
        global _DEFERRED
        self._prev = _DEFERRED
        _DEFERRED = []
        return self

    def __exit__(self, exc_type, exc, tb):
        global _DEFERRED
        entries, _DEFERRED = _DEFERRED, self._prev
        if exc_type is not None:
            return False
        if not entries:
            return False
        with span("g1.subgroup_ladder", points=len(entries)):
            _check_subgroup(entries)
        return False


def _count_parallel(threads: int, n: int) -> None:
    """Count the `n` points of a native validation call that ran on more
    than one thread (the call returns the threads it used)."""
    if threads > 1:
        count("g1.validate_parallel_points", n)


def _check_subgroup(entries) -> None:
    """Subgroup-check the deferred (bytes, point) pairs in one batched
    native ladder (the Python check without it); cache the points."""
    pts = [p for _, p in entries]
    try:
        import ctypes

        from . import native

        lib = native.lib()
        if lib is not None and hasattr(lib, "cp_subgroup_check"):
            flags = ctypes.create_string_buffer(len(pts))
            _count_parallel(
                lib.cp_subgroup_check(native.pts_to_bytes(pts), len(pts),
                                      flags, 0), len(pts))
            if any(flags.raw):
                raise SerializationError(
                    "point not in the prime-order subgroup")
            if _cache_enabled():
                for buf, p in entries:
                    if buf is not None:
                        _cache_put(buf, p)
            return
    except SerializationError:
        raise
    except Exception:
        pass
    for buf, pt in entries:
        if not pt.is_in_correct_subgroup():
            raise SerializationError(
                "point not in the prime-order subgroup")
        if buf is not None and _cache_enabled():
            _cache_put(buf, pt)


def g1_from_bytes(buf: bytes, validate: bool = True) -> G1:
    """Deserialize a ZCash-format compressed point; checks curve + subgroup.

    The parse + square root runs on the native engine when available (the
    python pow() sqrt costs ~0.3 ms/point — proof deserialization touches
    ~90 points); the subgroup check stays python/deferred so the 8-wide
    batched checker keeps its lanes full."""
    if len(buf) != 48:
        raise SerializationError("G1 compressed encoding must be 48 bytes")
    if _CACHE and _cache_enabled():
        cached = _CACHE.get(buf)
        if cached is not None:
            count("g1.decompress_cache_hits")
            return cached
    p = _native_decompress_nosub(buf)
    if p is not None:
        if validate:
            if _DEFERRED is not None:
                _DEFERRED.append((buf, p))
            elif not p.is_in_correct_subgroup():
                raise SerializationError(
                    "point not in the prime-order subgroup")
            elif _cache_enabled():
                _cache_put(buf, p)
        return p
    flags = buf[0] & 0xE0
    if not flags & _COMPRESSED_FLAG:
        raise SerializationError("expected compressed encoding")
    if flags & _INFINITY_FLAG:
        if flags & _SORT_FLAG or any(buf[1:]) or (buf[0] & 0x1F):
            raise SerializationError("malformed infinity encoding")
        return G1.infinity()
    body = bytes([buf[0] & 0x1F]) + buf[1:]
    x = int.from_bytes(body, "big")
    if x >= Q:
        raise SerializationError("x coordinate not in field")
    ys = get_ys_from_x(x)
    if ys is None:
        raise SerializationError("x is not on the curve")
    y = ys[1] if flags & _SORT_FLAG else ys[0]
    p = G1.from_affine(x, y)
    if validate:
        if _DEFERRED is not None:
            _DEFERRED.append((buf, p))  # batch-checked when the context exits
        elif not p.is_in_correct_subgroup():
            raise SerializationError("point not in the prime-order subgroup")
        elif _cache_enabled():
            _cache_put(buf, p)
    return p


def fr_to_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "little")


_DECOMPRESS_FLAG_ERRORS = {
    1: "malformed compressed encoding",
    2: "x is not on the curve",
    3: "point not in the prime-order subgroup",
}


def _native_decompress_nosub(buf: bytes) -> G1 | None:
    """Native parse + sqrt of one compressed point (no subgroup check).
    Returns None when the native library is unavailable; raises on invalid
    encodings.  Flag semantics match `_DECOMPRESS_FLAG_ERRORS`."""
    try:
        import ctypes

        from . import native

        lib = native.lib()
        if lib is None or not hasattr(lib, "cp_g1_decompress_validate"):
            return None
        out = ctypes.create_string_buffer(144)
        flags = ctypes.create_string_buffer(1)
        lib.cp_g1_decompress_validate(buf, 1, out, flags, 0, 0)
    except SerializationError:
        raise
    except Exception:
        return None
    if flags.raw[0]:
        raise SerializationError(_DECOMPRESS_FLAG_ERRORS[flags.raw[0]])
    return native.pts_from_bytes(out.raw, 1)[0]


def g1_from_bytes_batch(bufs: list[bytes], validate: bool = True) -> list[G1]:
    """Decompress many 48-byte points; native batch path (IFMA sqrt + 8-wide
    subgroup ladder, ~11x the per-point python path) when available.

    The native call splits the points across the process's cores (its
    affinity mask), at most one thread per 64 points, each thread running
    the same per-point checks on the contiguous pieces it claims; the counter
    `g1.validate_parallel_points` counts the points of calls that ran on
    more than one thread.  Within the call, points with the same bytes are
    decompressed once while the decompress cache is on.

    Inside a `deferred_subgroup_checks` context the subgroup test is queued
    (one big batched ladder at context exit) so decompress costs only the
    parse + sqrt.  A bad point, a wrong length included, raises
    `SerializationError` for the lowest index that fails, with that index as
    its `index`."""
    cache = _cache_enabled()
    hits = ([_CACHE.get(b) for b in bufs]
            if _CACHE and cache else [None] * len(bufs))
    miss_idx = [i for i, h in enumerate(hits) if h is None]
    if len(miss_idx) < len(bufs):
        count("g1.decompress_cache_hits", len(bufs) - len(miss_idx))
    if not miss_idx:
        return hits
    if validate and len(miss_idx) >= 4:
        try:
            import ctypes

            from . import native

            lib = native.lib()
            if lib is not None and hasattr(lib, "cp_g1_decompress_validate"):
                if cache:   # first occurrence of each encoding
                    first = {}
                    for i in miss_idx:
                        first.setdefault(bufs[i], i)
                    todo = list(first.values())
                else:
                    todo = miss_idx
                miss_bufs = [bufs[i] for i in todo]
                # the points before the first wrong length are read; one of
                # them failing fails first
                n = next((j for j, b in enumerate(miss_bufs) if len(b) != 48),
                         len(miss_bufs))
                del miss_bufs[n:]
                defer = _DEFERRED is not None
                out = ctypes.create_string_buffer(144 * n)
                flags = ctypes.create_string_buffer(n)
                _count_parallel(
                    lib.cp_g1_decompress_validate(
                        b"".join(miss_bufs), n, out, flags,
                        0 if defer else 1, 0), n)
                for j, f in enumerate(flags.raw):
                    if f:
                        raise SerializationError(
                            f"point {todo[j]}: " + _DECOMPRESS_FLAG_ERRORS[f],
                            todo[j])
                if n < len(todo):
                    raise SerializationError(
                        f"point {todo[n]}: G1 compressed encoding must be "
                        "48 bytes", todo[n])
                pts = native.pts_from_bytes(out.raw, n)
                if defer:
                    _DEFERRED.extend(zip(miss_bufs, pts))
                elif cache:
                    for b, p in zip(miss_bufs, pts):
                        _cache_put(b, p)
                got = dict(zip(miss_bufs, pts)) if cache else None
                for j, i in enumerate(miss_idx):
                    hits[i] = got[bufs[i]] if cache else pts[j]
                return hits
        except SerializationError:
            raise
        except Exception:
            pass
    for i in miss_idx:
        try:
            hits[i] = g1_from_bytes(bufs[i], validate=validate)
        except SerializationError as e:
            e.index = i
            raise
    return hits


def fr_from_bytes(buf: bytes) -> int:
    """Canonical deserialization: 32-byte LE, must be < r."""
    if len(buf) != 32:
        raise SerializationError("Fr encoding must be 32 bytes")
    v = int.from_bytes(buf, "little")
    if v >= R:
        raise SerializationError("scalar not in field")
    return v


def fr_from_le_bytes_mod_order(buf: bytes) -> int:
    """arkworks `Fr::from_le_bytes_mod_order` (`whisk.rs:343-345`)."""
    return int.from_bytes(buf, "little") % R


def fr_from_random_bytes(buf: bytes) -> int | None:
    """arkworks `Fr::from_random_bytes`: first 32 bytes LE, masked to the
    modulus bit size (255 bits — the top bit is shaved); None if >= r.

    Used by the transcript challenge rejection loop (`transcript.rs:41-54`).
    """
    v = int.from_bytes(buf[:32], "little") & ((1 << 255) - 1)
    if v >= R:
        return None
    return v


def vec_len_prefix(n: int) -> bytes:
    """ark-serialize Vec<T> length prefix: u64 little-endian."""
    return n.to_bytes(8, "little")
