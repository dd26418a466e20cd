"""Curdleproofs Fiat-Shamir transcript over Merlin.

Parity with `curdleproofs/src/transcript.rs:14-61`: append = compressed
serialization then `append_message`; challenge = 64-byte `challenge_bytes`,
take the first 32 bytes LE as an Fr candidate, reject zero/overflow and retry,
then re-append the accepted challenge under the same label.

Typed append helpers mirror the ark-serialize encodings the Rust code produces:
single points/scalars have no length prefix, `Vec<T>` carries an 8-byte LE
length prefix (used at `curdleproofs.rs:81`, `same_permutation_argument.rs:62`,
`same_multiscalar_argument.rs:85`).
"""

from __future__ import annotations

from .host.g1 import G1
from .host.serde import fr_from_random_bytes, fr_to_bytes, g1_to_bytes, vec_len_prefix
from .host.strobe import MerlinTranscript

__all__ = ["Transcript"]

# Joined Vec<G1Affine> payloads, memoized per list OBJECT (same contract as
# ops/msm_device._BASES_CACHE: protocol code never mutates point lists after
# handing them out). Batch verification replays append the same instance
# vectors (R, S per batch; T, U twice per proof), so the ~250-point joins
# dominate transcript cost without this.
_PAYLOAD_MEMO: dict[int, tuple[list, bytes]] = {}


def _points_payload(points: list[G1]) -> bytes:
    if len(points) < 16:
        return (vec_len_prefix(len(points))
                + b"".join(g1_to_bytes(p) for p in points))
    key = id(points)
    hit = _PAYLOAD_MEMO.get(key)
    if hit is not None and hit[0] is points:
        return hit[1]
    payload = (vec_len_prefix(len(points))
               + b"".join(g1_to_bytes(p) for p in points))
    if len(_PAYLOAD_MEMO) > 64:
        _PAYLOAD_MEMO.clear()
    _PAYLOAD_MEMO[key] = (points, payload)
    return payload


class Transcript:
    def __init__(self, label: bytes):
        self._t = MerlinTranscript(label)

    # --- raw ------------------------------------------------------------
    def append_message(self, label: bytes, message: bytes) -> None:
        self._t.append_message(label, message)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        return self._t.challenge_bytes(label, n)

    # --- typed appends (ark-serialize compressed encodings) ---------------
    def append_point(self, label: bytes, p: G1) -> None:
        self._t.append_message(label, g1_to_bytes(p))

    def append_points(self, label: bytes, points: list[G1]) -> None:
        """`append_list` over individual point items."""
        if len(points) > 2:
            msgs = b"".join(g1_to_bytes(p) for p in points)
            self._t.append_equal_messages(label, msgs, 48, len(points))
            return
        for p in points:
            self.append_point(label, p)

    def append_point_vec(self, label: bytes, points: list[G1]) -> None:
        """Append a Rust `Vec<G1Affine>` as ONE message with a u64 length prefix."""
        self._t.append_message(label, _points_payload(points))

    def append_fr(self, label: bytes, v: int) -> None:
        self._t.append_message(label, fr_to_bytes(v))

    def append_fr_vec(self, label: bytes, vs: list[int]) -> None:
        """Append a Rust `Vec<Fr>` as ONE message with a u64 length prefix."""
        payload = vec_len_prefix(len(vs)) + b"".join(fr_to_bytes(v) for v in vs)
        self._t.append_message(label, payload)

    # --- challenges ------------------------------------------------------
    def get_and_append_challenge(self, label: bytes) -> int:
        while True:
            buf = self._t.challenge_bytes(label, 64)
            e = fr_from_random_bytes(buf)
            if e is not None and e != 0:
                self.append_fr(label, e)
                return e

    def get_and_append_challenges(self, label: bytes, n: int) -> list[int]:
        return [self.get_and_append_challenge(label) for _ in range(n)]
