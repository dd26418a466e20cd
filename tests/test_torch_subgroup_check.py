"""The port's native point validation against the Python ground truth, at
every thread count the split can take.

`cp_g1_decompress_validate` (eager: parse, curve check, square root and
the endomorphism membership test inline; with `check_subgroup` = 0 the
parse alone) and `cp_subgroup_check` (the deferred test over Jacobian
points) cut their points into contiguous pieces, which threads claim in
turn.  The
cases here hold each entry, at `threads` = 1, 2, 3, 16 and 0 (the
process's cores) and n = 1, 7, 63, 64, 65 and 300, to:

- the ground truth: the encoding's flags read in Python and
  `G1.is_in_correct_subgroup` ([r]P), over good G1 points, on-curve
  points outside G1, pure cofactor-torsion points T = [r]P' (which an
  unsound endomorphism shortcut would admit), infinity, x not on the
  curve, x >= q, a missing compression flag and malformed infinities;
- the same flags and output bytes at every thread count, on the IFMA path
  and on the scalar path (`CP_NO_IFMA=1`);
- one bad point flagged wherever it sits: the first point, either side of
  a piece's edge, the last point;
- the automatic thread count: one thread up to 64 points, at most one per
  64 points and no more than the process's affinity mask allows.

And `g1_from_bytes_batch` raises for the lowest failing index (a wrong
length counts as a failure at its index) and gives it as the error's
`index`, with the pure-Python path's messages as they were, counts
`g1.validate_parallel_points` when the split engages, and with the
decompress cache on validates an encoding that repeats in one call once.

Tolerance: exact."""

import ctypes
import os
import random
import subprocess
import sys

import pytest

from curdleproofs_tpu_torch.constants import Q, R
from curdleproofs_tpu_torch.host import native, serde
from curdleproofs_tpu_torch.host.g1 import G1, get_point_from_x, get_ys_from_x
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.utils import trace

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = (1, 2, 3, 16, 0)   # 16 oversubscribes an 8-core host
SIZES = (1, 7, 63, 64, 65, 300)
# bls12_381.cpp: SPLIT_ALIGN, SPLIT_MIN_POINTS, SPLIT_PIECES
ALIGN, MIN_POINTS, PIECES = 24, 64, 8


def _not_in_g1(count: int, rnd: random.Random) -> list[G1]:
    out, x = [], 7
    while len(out) < count:
        x += 1
        p = get_point_from_x(x, bool(rnd.getrandbits(1)))
        if p is not None and not p.is_in_correct_subgroup():
            out.append(p)
    return out


def _off_curve_x(count: int) -> list[int]:
    out, x = [], 3
    while len(out) < count:
        x += 1
        if get_ys_from_x(x) is None:
            out.append(x)
    return out


def _enc_x(x: int, flags: int = 0x80) -> bytes:
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def _truth(buf: bytes):
    """(flag, point) of one encoding, read in Python: 0 valid, 1 malformed,
    2 x not on the curve, 3 not in G1 (as `_DECOMPRESS_FLAG_ERRORS`)."""
    if not buf[0] & 0x80:
        return 1, None
    if buf[0] & 0x40:
        ok = not (buf[0] & 0x3F) and not any(buf[1:])
        return (0, G1.infinity()) if ok else (1, None)
    x = int.from_bytes(bytes([buf[0] & 0x1F]) + buf[1:], "big")
    if x >= Q:
        return 1, None
    ys = get_ys_from_x(x)
    if ys is None:
        return 2, None
    p = G1.from_affine(x, ys[1] if buf[0] & 0x20 else ys[0])
    return (0, p) if p.is_in_correct_subgroup() else (3, p)


def _jacobian(p: G1, lam: int) -> G1:
    """The same point with z = lam (x * lam^2, y * lam^3, lam)."""
    if p.is_infinity():
        return p
    x, y = p.to_affine()
    return G1(x * lam * lam % Q, y * pow(lam, 3, Q) % Q, lam)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@pytest.fixture(scope="module")
def pool():
    """300 encodings with every kind of bad point among good ones (one of
    each kind in the first 8), their ground truth, and Jacobian forms of
    the curve points for the deferred entry."""
    rnd = random.Random(2121)
    rng = StdRng.seed_from_u64(2121)
    outside = _not_in_g1(8, rnd)
    torsion = [t for t in (p.mul_bigint(R) for p in outside)
               if not t.is_infinity()]
    assert torsion, "expected nonzero cofactor components"
    good = [serde.g1_to_bytes(rng.rand_g1()) for _ in range(300)]
    infinity = bytes([0xC0]) + bytes(47)
    kinds = [
        [serde.g1_to_bytes(p) for p in outside],        # on the curve, not G1
        [serde.g1_to_bytes(t) for t in torsion],        # cofactor torsion
        [_enc_x(x) for x in _off_curve_x(4)],           # x not on the curve
        [_enc_x(Q), _enc_x(Q + 5)],                     # x >= q
        [bytes([b[0] & 0x7F]) + b[1:] for b in good[:2]],   # not compressed
        [infinity[:7] + b"\x01" + infinity[8:],          # malformed infinity
         bytes([0xE0]) + bytes(47)],
        [infinity],
    ]
    bufs = list(good)
    for k, kind in enumerate(kinds):   # one of each kind up front
        bufs[1 + k] = kind[0]
    rest = [b for kind in kinds for b in kind[1:]]
    for k, b in enumerate(rest):       # the rest spread over the pool
        bufs[9 + (k * 41) % 290] = b
    truth = [_truth(b) for b in bufs]
    assert {f for f, _ in truth} == {0, 1, 2, 3}
    jac = [_jacobian(p, rnd.randrange(2, Q)) if p is not None
           else G1.infinity() for _, p in truth]
    return bufs, truth, jac


def _decompress(bufs, check_subgroup: int, threads: int):
    n = len(bufs)
    out = ctypes.create_string_buffer(144 * n)
    flags = ctypes.create_string_buffer(n)
    used = native.lib().cp_g1_decompress_validate(
        b"".join(bufs), n, out, flags, check_subgroup, threads)
    return list(flags.raw), out.raw, used


def _subgroup(pts, threads: int):
    flags = ctypes.create_string_buffer(len(pts))
    used = native.lib().cp_subgroup_check(native.pts_to_bytes(pts), len(pts),
                                          flags, threads)
    return list(flags.raw), b"", used


def _run(entry: str, pool, n: int, threads: int):
    bufs, _, jac = pool
    if entry == "deferred":
        return _subgroup(jac[:n], threads)
    return _decompress(bufs[:n], 1 if entry == "eager" else 0, threads)


def _want(entry: str, pool, n: int) -> list[int]:
    truth = pool[1][:n]
    if entry == "eager":
        return [f for f, _ in truth]
    if entry == "parse":
        return [0 if f == 3 else f for f, _ in truth]
    # deferred: every point given is on the curve; 1 = not in G1
    return [1 if f == 3 else 0 for f, _ in truth]


def _piece(n: int, threads: int) -> int:
    """The split's piece: an eighth of a thread's share, rounded up to
    whole lane groups."""
    return max(ALIGN, _cdiv(_cdiv(n, threads * PIECES), ALIGN) * ALIGN)


def _expected_threads(n: int, threads: int) -> int:
    t = threads or min(len(os.sched_getaffinity(0)), _cdiv(n, MIN_POINTS))
    t = max(t, 1)
    return max(1, min(t, _cdiv(n, _piece(n, t))))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("entry", ("eager", "parse", "deferred"))
def test_flags_and_bytes_match_python_at_every_split(pool, entry, threads, n):
    flags, out, used = _run(entry, pool, n, threads)
    assert flags == _want(entry, pool, n)
    assert used == _expected_threads(n, threads)
    one = _run(entry, pool, n, 1)
    assert (flags, out) == one[:2]
    if entry != "deferred":
        pts = native.pts_from_bytes(out, n)
        for i, (f, (_, p)) in enumerate(zip(flags, pool[1][:n])):
            if f == 0:
                assert pts[i] == p
            else:
                assert out[144 * i:144 * (i + 1)] == bytes(144)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("entry", ("eager", "parse", "deferred"))
def test_scalar_path_gives_the_same_answers(pool, entry, threads,
                                            monkeypatch):
    want = _run(entry, pool, 300, 1)
    monkeypatch.setenv("CP_NO_IFMA", "1")
    flags, out, _ = _run(entry, pool, 300, threads)
    assert flags == _want(entry, pool, 300)
    assert (flags, out) == want[:2]


@pytest.fixture(scope="module")
def clean():
    """200 good encodings, and a bad one of each kind the entries flag."""
    rng = StdRng.seed_from_u64(77)
    good = [rng.rand_g1() for _ in range(200)]
    outside = _not_in_g1(1, random.Random(77))[0]
    return good, outside, _enc_x(_off_curve_x(1)[0])


def _edges(n: int, threads: int) -> dict[str, int]:
    piece = _piece(n, threads)
    return {"first": 0, "piece_end": piece - 1, "piece_start": piece,
            "last": n - 1}


@pytest.mark.parametrize("where", ("first", "piece_end", "piece_start",
                                   "last"))
@pytest.mark.parametrize("threads", (2, 3))
@pytest.mark.parametrize("entry", ("eager", "parse", "deferred"))
def test_a_bad_point_is_flagged_wherever_it_sits(clean, entry, threads,
                                                 where):
    good, outside, off_curve = clean
    n = len(good)
    i = _edges(n, threads)[where]
    if entry == "deferred":
        pts = list(good)
        pts[i] = _jacobian(outside, 5)
        flags, _, used = _subgroup(pts, threads)
        bad_flag = 1
    else:
        bufs = [serde.g1_to_bytes(p) for p in good]
        bufs[i] = serde.g1_to_bytes(outside) if entry == "eager" else off_curve
        flags, _, used = _decompress(bufs, entry == "eager", threads)
        bad_flag = 3 if entry == "eager" else 2
    assert used == threads
    assert flags == [bad_flag if j == i else 0 for j in range(n)]


def test_the_automatic_count_follows_the_affinity_mask():
    """Pinned to one core the split stays on the calling thread; pinned to
    two it takes two; at 64 points or fewer it never splits."""
    code = (
        "import ctypes, os, sys\n"
        f"sys.path.insert(0, {_REPO!r})\n"
        "from curdleproofs_tpu_torch.host import native, serde\n"
        "from curdleproofs_tpu_torch.host.rng import StdRng\n"
        "rng = StdRng.seed_from_u64(3)\n"
        "bufs = b''.join(serde.g1_to_bytes(rng.rand_g1())\n"
        "                for _ in range(300))\n"
        "lib = native.lib()\n"
        "def used(n):\n"
        "    out = ctypes.create_string_buffer(144 * n)\n"
        "    flags = ctypes.create_string_buffer(n)\n"
        "    return lib.cp_g1_decompress_validate(bufs, n, out, flags, 1, 0)\n"
        "cores = sorted(os.sched_getaffinity(0))\n"
        "got = []\n"
        "for k in (1, 2):\n"
        "    os.sched_setaffinity(0, cores[:k])\n"
        "    got.append([used(64), used(300)])\n"
        "print(len(cores), got)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ncores, got = r.stdout.split(" ", 1)
    assert got.strip() == ("[[1, 1], [1, 2]]" if int(ncores) >= 2
                           else "[[1, 1], [1, 1]]")


@pytest.fixture
def recorder():
    trace.enable(False)
    trace.reset()
    yield trace
    trace.enable(False)
    trace.reset()


@pytest.mark.parametrize("n", (7, 64, 65, 300))
def test_batch_counts_the_points_it_split(pool, recorder, monkeypatch, n):
    monkeypatch.setenv("CP_NO_DECOMPRESS_CACHE", "1")
    bufs = [b for b, (f, _) in zip(pool[0], pool[1]) if f == 0][:n]
    bufs += [serde.g1_to_bytes(p) for p in
             (StdRng.seed_from_u64(n).rand_g1() for _ in range(n - len(bufs)))]
    trace.enable()
    got = serde.g1_from_bytes_batch(bufs)
    assert [serde.g1_to_bytes(p) for p in got] == bufs
    split = _expected_threads(n, 0) > 1
    assert trace.counters().get("g1.validate_parallel_points", 0) == \
        (n if split else 0)


@pytest.mark.parametrize("defer", (False, True))
def test_batch_raises_for_the_lowest_failing_index(pool, monkeypatch, defer):
    """Two bad points in different pieces: the error names the first."""
    monkeypatch.setenv("CP_NO_DECOMPRESS_CACHE", "1")
    good = [b for b, (f, _) in zip(pool[0], pool[1]) if f == 0]
    outside = next(b for b, (f, _) in zip(pool[0], pool[1]) if f == 3)
    bufs = (good * 2)[:300]
    bufs[250] = _enc_x(Q)       # malformed, in the last piece
    bufs[100] = outside         # not in G1, earlier
    if defer:   # the parse alone: the malformed point is the only failure
        with pytest.raises(serde.SerializationError,
                           match=r"^point 250: malformed") as got:
            with serde.deferred_subgroup_checks():
                serde.g1_from_bytes_batch(bufs)
        assert got.value.index == 250
    else:
        with pytest.raises(serde.SerializationError,
                           match=r"^point 100: point not in the prime-order"
                           ) as got:
            serde.g1_from_bytes_batch(bufs)
        assert got.value.index == 100


@pytest.mark.parametrize("short_first", (True, False))
def test_batch_counts_a_wrong_length_as_a_failure_at_its_index(
        pool, monkeypatch, short_first):
    """A 47-byte encoding before a point outside G1 is the error; after
    one, the point outside G1 is."""
    monkeypatch.setenv("CP_NO_DECOMPRESS_CACHE", "1")
    good = [b for b, (f, _) in zip(pool[0], pool[1]) if f == 0]
    outside = next(b for b, (f, _) in zip(pool[0], pool[1]) if f == 3)
    bufs = (good * 2)[:300]
    short, bad = (100, 250) if short_first else (250, 100)
    bufs[short] = bufs[short][:47]
    bufs[bad] = outside
    with pytest.raises(serde.SerializationError) as got:
        serde.g1_from_bytes_batch(bufs)
    assert got.value.index == min(short, bad)
    assert str(got.value) == (
        "point 100: G1 compressed encoding must be 48 bytes" if short_first
        else "point 100: point not in the prime-order subgroup")


@pytest.mark.parametrize("bad", ("short", "malformed", "outside"))
def test_the_python_path_keeps_its_messages_and_gives_the_index(
        pool, monkeypatch, bad):
    """Below four points the batch runs the per-point Python path: its
    error reads as `g1_from_bytes`'s, and carries the point's index."""
    monkeypatch.setenv("CP_NO_DECOMPRESS_CACHE", "1")
    good = [b for b, (f, _) in zip(pool[0], pool[1]) if f == 0][:3]
    buf = {"short": good[2][:47], "malformed": _enc_x(Q),
           "outside": next(b for b, (f, _) in zip(pool[0], pool[1])
                           if f == 3)}[bad]
    with pytest.raises(serde.SerializationError) as want:
        serde.g1_from_bytes(buf)
    with pytest.raises(serde.SerializationError) as got:
        serde.g1_from_bytes_batch(good[:2] + [buf])
    assert str(got.value) == str(want.value)
    assert got.value.index == 2


@pytest.mark.parametrize("cache", (True, False))
def test_batch_decompresses_a_repeated_encoding_once_with_the_cache_on(
        recorder, monkeypatch, cache):
    """With the decompress cache on, an encoding that repeats in one call
    (a chain's post-trackers returning as the next block's pre-trackers)
    is validated once and both positions get the same point; with it off,
    every position goes through the native call."""
    monkeypatch.setattr(serde, "_CACHE", {})
    if cache:
        monkeypatch.delenv("CP_NO_DECOMPRESS_CACHE", raising=False)
    else:
        monkeypatch.setenv("CP_NO_DECOMPRESS_CACHE", "1")
    rng = StdRng.seed_from_u64(4242)
    once = [serde.g1_to_bytes(rng.rand_g1()) for _ in range(150)]
    trace.enable()
    got = serde.g1_from_bytes_batch(once + once)
    assert [serde.g1_to_bytes(p) for p in got] == once + once
    assert all((a is b) == cache for a, b in zip(got[:150], got[150:]))
    n = 150 if cache else 300
    want = n if _expected_threads(n, 0) > 1 else 0
    assert trace.counters().get("g1.validate_parallel_points", 0) == want
    assert len(serde._CACHE) == (150 if cache else 0)
