"""Byte codecs, bit-exact with arkworks `ark-serialize` 0.4 + `ark-bls12-381` 0.4.

G1 points use the 48-byte ZCash compressed format (flags in the three top bits of
the first byte); Fr uses 32-byte little-endian canonical form. Golden anchors:
generator bytes at `curdleproofs/src/whisk.rs:364-368` and Fr round-trip at
`whisk.rs:354-362`.
"""

from __future__ import annotations

from ..constants import Q, R
from .g1 import G1, get_ys_from_x

__all__ = [
    "g1_to_bytes", "g1_from_bytes", "fr_to_bytes", "fr_from_bytes",
    "fr_from_le_bytes_mod_order", "fr_from_random_bytes", "vec_len_prefix",
    "SerializationError",
    "g1_from_bytes_batch",
    "deferred_subgroup_checks",
]


class SerializationError(ValueError):
    pass


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
# pairs queue here and their subgroup membership is checked in one call
# to `plain.in_subgroup` at context exit.
_DEFERRED: list | None = None

# Validated decompressions: 48-byte compressed encoding -> G1.  Subgroup
# membership is a property of the bytes, so serving a cached point is
# sound; entries go in only after the curve and subgroup checks passed.
_CACHE: dict[bytes, G1] = {}
_CACHE_CAP = 1 << 17


def _cache_put(entries) -> None:
    if len(_CACHE) >= _CACHE_CAP:
        _CACHE.clear()
    for buf, p in entries:
        _CACHE[buf] = p


def _check_subgroup(entries) -> None:
    from . import plain

    if not all(plain.in_subgroup([p for _, p in entries])):
        raise SerializationError("point not in the prime-order subgroup")
    _cache_put(entries)


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
        if exc_type is None and entries:
            _check_subgroup(entries)
        return False


def _decompress(buf: bytes) -> G1:
    """Parse a ZCash-format compressed point and take its y (curve check
    included, subgroup check not)."""
    if len(buf) != 48:
        raise SerializationError("G1 compressed encoding must be 48 bytes")
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
    return G1.from_affine(x, ys[1] if flags & _SORT_FLAG else ys[0])


def g1_from_bytes(buf: bytes, validate: bool = True) -> G1:
    """Deserialize a ZCash-format compressed point; checks curve + subgroup."""
    return g1_from_bytes_batch([buf], validate)[0]


def fr_to_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "little")


def g1_from_bytes_batch(bufs: list[bytes], validate: bool = True) -> list[G1]:
    """Decompress many 48-byte points.  Inside a `deferred_subgroup_checks`
    context the subgroup checks are queued for its exit."""
    out = [_CACHE.get(b) for b in bufs]
    fresh = []
    for i, b in enumerate(bufs):
        if out[i] is None:
            out[i] = _decompress(b)
            if not out[i].is_infinity():
                fresh.append((b, out[i]))
    if validate and fresh:
        if _DEFERRED is not None:
            _DEFERRED.extend(fresh)
        else:
            _check_subgroup(fresh)
    return out


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
