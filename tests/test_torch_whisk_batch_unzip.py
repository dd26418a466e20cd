"""The sync batch's tracker decompression on the CPU: one native call for
every block's pre- and post-trackers (`whisk._unzip_trackers` over all the
lists, split across the process's cores), in place of one call a list.

- a valid batch and a batch with one tampered proof give the verdicts the
  single-proof path gives block by block (which keeps its call a list),
  and `identify=True` names the tampered block;
- with two bad trackers in different blocks (malformed, outside G1, or
  47 bytes long), the batch raises the `SerializationError` that calling
  once a list, in order, raises first, naming its block, its list and
  its position there;
- with recording on, the batch records one `whisk.unzip_trackers` span
  over all its points, and `g1.validate_parallel_points` counts the
  points of every native call that ran on more than one thread.

Tolerance: exact."""

import os

import pytest

from curdleproofs_tpu_torch.backend import HostBackend, use_backend
from curdleproofs_tpu_torch.constants import Q
from curdleproofs_tpu_torch.curdleproofs import generate_crs
from curdleproofs_tpu_torch.host import serde
from curdleproofs_tpu_torch.host.g1 import GENERATOR, get_point_from_x
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.utils import trace
from curdleproofs_tpu_torch.whisk import (
    WhiskTracker, _unzip_trackers, generate_whisk_shuffle_proof,
    is_valid_whisk_shuffle_proof, is_valid_whisk_shuffle_proofs,
)

ELL, BLOCKS = 12, 3


@pytest.fixture(scope="module")
def batch():
    """Three Whisk blocks at l = 12, each with fresh pre-trackers (as a
    sync batch's), made on the host backend."""
    rng = StdRng.seed_from_u64(2101)
    crs = generate_crs(ELL)
    out = []
    with use_backend(HostBackend()):
        for _ in range(BLOCKS):
            pre = []
            for _ in range(ELL):
                k, r = rng.rand_fr(), rng.rand_fr()
                r_G = GENERATOR.mul(r)
                pre.append(WhiskTracker(serde.g1_to_bytes(r_G),
                                        serde.g1_to_bytes(r_G.mul(k))))
            post, proof = generate_whisk_shuffle_proof(rng, crs, pre)
            out.append((pre, post, proof))
    return crs, out


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No decompress cache (as the sync cell) and an empty recorder that
    is off, before and after."""
    monkeypatch.setenv("CP_NO_DECOMPRESS_CACHE", "1")
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.mark.parametrize("tampered", (None, 1))
def test_verdicts_match_the_single_proof_path(batch, tampered):
    crs, shuffles = batch
    shuffles = list(shuffles)
    if tampered is not None:
        pre, post, proof = shuffles[tampered]
        bad = bytearray(proof)
        bad[-1] ^= 1                  # a scalar's last byte
        shuffles[tampered] = (pre, post, bytes(bad))
    with use_backend(HostBackend()):
        single = [is_valid_whisk_shuffle_proof(StdRng.seed_from_u64(9), crs,
                                               *s) for s in shuffles]
        whole = is_valid_whisk_shuffle_proofs(StdRng.seed_from_u64(9), crs,
                                              shuffles)
        each = is_valid_whisk_shuffle_proofs(StdRng.seed_from_u64(9), crs,
                                             shuffles, identify=True)
    assert single == [b != tampered for b in range(BLOCKS)]
    assert whole is all(single)
    assert each == (True if all(single) else single)  # bisects on failure


def _outside_g1() -> bytes:
    x = 7
    while True:
        x += 1
        p = get_point_from_x(x, False)
        if p is not None and not p.is_in_correct_subgroup():
            return serde.g1_to_bytes(p)


def _plant(tracker: WhiskTracker, coord: str, buf: bytes) -> WhiskTracker:
    return WhiskTracker(buf if coord == "r_G" else tracker.r_G,
                        buf if coord == "k_r_G" else tracker.k_r_G)


def _first_error_a_list(shuffles) -> str:
    """The error that one call a tracker list, block by block and pre
    before post, raises first, with its block and list."""
    for b, (pre, post, _) in enumerate(shuffles):
        for side, trackers in (("pre", pre), ("post", post)):
            try:
                _unzip_trackers(trackers)
            except serde.SerializationError as e:
                return f"block {b} {side}_trackers: {e}"
    raise AssertionError("no tracker failed")


def _bad(kind: str, tracker: WhiskTracker, coord: str) -> bytes:
    if kind == "short":
        return getattr(tracker, coord)[:47]
    if kind == "outside":
        return _outside_g1()
    malformed = bytearray(Q.to_bytes(48, "big"))
    malformed[0] |= 0x80              # x >= q
    return bytes(malformed)


# (block, list, tracker, coordinate, kind) of two bad trackers, the one
# the batch must name first
PLANTS = {
    "malformed_first": ((0, "post", 3, "k_r_G", "malformed"),
                        (2, "pre", 5, "r_G", "outside")),
    "outside_first": ((1, "pre", 0, "k_r_G", "outside"),
                      (2, "post", 7, "r_G", "malformed")),
    "short_later": ((0, "post", 3, "k_r_G", "malformed"),
                    (1, "pre", 2, "r_G", "short")),
    "short_first": ((1, "post", 9, "r_G", "short"),
                    (2, "pre", 0, "k_r_G", "outside")),
}
WHAT = {"malformed": "malformed compressed encoding",
        "outside": "point not in the prime-order subgroup",
        "short": "G1 compressed encoding must be 48 bytes"}


@pytest.mark.parametrize("case", sorted(PLANTS))
def test_the_first_bad_tracker_is_named_with_its_block(batch, case):
    crs, shuffles = batch
    shuffles = [(list(pre), list(post), proof)
                for pre, post, proof in shuffles]
    for b, side, i, coord, kind in PLANTS[case]:
        lst = shuffles[b][0 if side == "pre" else 1]
        lst[i] = _plant(lst[i], coord, _bad(kind, lst[i], coord))
    want = _first_error_a_list(shuffles)
    b, side, i, coord, kind = PLANTS[case][0]
    at = i + (ELL if coord == "k_r_G" else 0)
    assert want == f"block {b} {side}_trackers: point {at}: {WHAT[kind]}"
    with use_backend(HostBackend()), \
            pytest.raises(serde.SerializationError) as got:
        is_valid_whisk_shuffle_proofs(StdRng.seed_from_u64(9), crs, shuffles)
    assert str(got.value) == want


def test_the_batch_counts_the_points_it_split(batch):
    crs, shuffles = batch
    trace.enable()
    with use_backend(HostBackend()):
        assert is_valid_whisk_shuffle_proofs(StdRng.seed_from_u64(9), crs,
                                             shuffles) is True
    recs = trace.records()
    (unzip,) = [r for r in recs if r.name == "whisk.unzip_trackers"]
    (ladder,) = [r for r in recs if r.name == "g1.subgroup_ladder"]
    points = [unzip.attrs["points"], ladder.attrs["points"]]
    assert points[0] == 4 * ELL * BLOCKS
    multi = len(os.sched_getaffinity(0)) > 1
    want = sum(n for n in points if multi and n > 64)
    assert want >= (4 * ELL * BLOCKS if multi else 0)
    assert trace.counters().get("g1.validate_parallel_points", 0) == want
