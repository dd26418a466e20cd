"""Strobe-128 duplex construction, matching merlin 3.0's internal `strobe.rs`.

The reference's Fiat-Shamir transcript is `merlin::Transcript`
(`curdleproofs/src/transcript.rs:14,28`); merlin is STROBE-128 over
Keccak-f[1600]. Only the subset merlin uses is implemented (meta_ad / ad / prf /
key), with identical state transitions so challenge byte streams match bit-for-bit.
"""

from __future__ import annotations

from .plain import keccak_f1600

_STROBE_R = 166  # security 128: R = 200 - 128/4 - 2

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # --- internal sponge ops ------------------------------------------------
    def _run_f(self) -> None:
        st = self.state
        st[self.pos] ^= self.pos_begin
        st[self.pos + 1] ^= 0x04
        st[_STROBE_R + 1] ^= 0x80
        keccak_f1600(st)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        st = self.state
        off = 0
        n = len(data)
        while off < n:
            take = min(n - off, _STROBE_R - self.pos)
            chunk = data[off : off + take]
            seg = bytes(a ^ b for a, b in zip(st[self.pos : self.pos + take],
                                              chunk)) if take < 32 else (
                int.from_bytes(st[self.pos : self.pos + take], "little")
                ^ int.from_bytes(chunk, "little")).to_bytes(take, "little")
            st[self.pos : self.pos + take] = seg
            self.pos += take
            off += take
            if self.pos == _STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        st = self.state
        for byte in data:
            st[self.pos] = byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        st = self.state
        for i in range(n):
            out[i] = st[self.pos]
            st[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "cannot continue a different op"
            return
        assert not flags & FLAG_T, "transport flags not implemented"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # --- public ops merlin uses ----------------------------------------------
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


class MerlinTranscript:
    """merlin 3.0 `Transcript` (new / append_message / challenge_bytes)."""

    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_equal_messages(self, label: bytes, msgs: bytes,
                              msg_size: int, count: int) -> None:
        """append_message(label, m) for `count` equal-size concatenated
        messages."""
        for i in range(count):
            self.append_message(label, msgs[i * msg_size : (i + 1) * msg_size])

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n, False)
