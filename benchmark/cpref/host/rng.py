"""Bit-exact clone of Rust `rand 0.8` `StdRng` (= ChaCha12) + arkworks sampling.

The reference derives every witness, blinder, and dev-CRS point from
`StdRng::seed_from_u64` (`curdleproofs/src/crs.rs:63`, test vectors in
`whisk.rs:383,418`). Reproducing its golden proof bytes requires an exact clone of:

- `rand_core 0.6` `seed_from_u64` (PCG32 seed expansion),
- `rand_chacha 0.3` ChaCha12 block generation + `BlockRng` word streaming,
- `rand 0.8` `gen_range` (widening-multiply rejection) and Fisher-Yates `shuffle`,
- `ark-ff 0.4` `Fp::rand` (raw bigint IS the Montgomery repr; shave + reject),
- `ark-ec 0.4` `Projective::rand` (sample x, bool for the larger root, clear cofactor).
"""

from __future__ import annotations

from ..constants import (
    FQ_MONT_R_INV, FQ_SHAVE_BITS, FR_MONT_R_INV, FR_SHAVE_BITS, Q, R,
)
from .g1 import G1, get_point_from_x
from .plain import chacha12_four_blocks

_MASK32 = (1 << 32) - 1
_MASK64 = (1 << 64) - 1


def _pcg32(state: int) -> tuple[int, int]:
    """One step of the PCG32 used by rand_core's seed_from_u64."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    state = (state * MUL + INC) & _MASK64
    xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
    rot = state >> 59
    x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
    return x, state


def seed_from_u64(seed: int) -> bytes:
    """Expand a u64 into a 32-byte seed (rand_core 0.6 `seed_from_u64`)."""
    state = seed & _MASK64
    out = bytearray()
    for _ in range(8):
        x, state = _pcg32(state)
        out += x.to_bytes(4, "little")
    return bytes(out)


class StdRng:
    """rand 0.8 StdRng (ChaCha12Rng) with BlockRng word-stream semantics."""

    def __init__(self, seed32: bytes):
        assert len(seed32) == 32
        self._key = [int.from_bytes(seed32[4 * i: 4 * i + 4], "little") for i in range(8)]
        self._counter = 0  # block counter, advances by 4 per refill
        self._results: list[int] = []
        self._index = 64  # force refill on first use

    @classmethod
    def seed_from_u64(cls, seed: int) -> "StdRng":
        return cls(seed_from_u64(seed))

    def _refill(self) -> None:
        self._results = chacha12_four_blocks(self._key, self._counter)
        self._counter = (self._counter + 4) & _MASK64
        self._index = 0

    # --- RngCore ------------------------------------------------------------
    def next_u32(self) -> int:
        if self._index >= 64:
            self._refill()
        v = self._results[self._index]
        self._index += 1
        return v

    def next_u64(self) -> int:
        # rand_core 0.6 BlockRng::next_u64 semantics (straddles refills).
        if self._index < 63:
            lo = self._results[self._index]
            hi = self._results[self._index + 1]
            self._index += 2
            return (hi << 32) | lo
        elif self._index >= 64:
            self._refill()
            self._index = 2
            return (self._results[1] << 32) | self._results[0]
        else:  # index == 63
            lo = self._results[63]
            self._refill()
            self._index = 1
            return (self._results[0] << 32) | lo

    def fill_bytes(self, n: int) -> bytes:
        # rand_core `fill_via_u32_chunks`: words little-endian, refill as needed.
        out = bytearray()
        while len(out) < n:
            if self._index >= 64:
                self._refill()
            need = n - len(out)
            while self._index < 64 and need > 0:
                w = self._results[self._index].to_bytes(4, "little")
                take = min(4, need)
                out += w[:take]
                self._index += 1
                need -= take
        return bytes(out)

    # --- rand 0.8 distributions ----------------------------------------------
    def gen_bool_standard(self) -> bool:
        """`rng.gen::<bool>()`: rand 0.8 sign test — true iff the MSB is set."""
        return self.next_u32() >= (1 << 31)

    def gen_range_u32(self, ubound: int) -> int:
        """`rng.gen_range(0..ubound)` for u32 (rand 0.8 sample_single)."""
        assert 0 < ubound <= 1 << 32
        range_ = ubound & _MASK32
        # zone = (range << range.leading_zeros()).wrapping_sub(1)
        lz = 32 - range_.bit_length() if range_ else 32
        zone = (((range_ << lz) & _MASK32) - 1) & _MASK32
        while True:
            v = self.next_u32()
            m = v * range_
            hi, lo = m >> 32, m & _MASK32
            if lo <= zone:
                return hi

    def shuffle(self, items: list) -> None:
        """rand 0.8 `SliceRandom::shuffle` (Fisher-Yates, high-to-low)."""
        for i in range(len(items) - 1, 0, -1):
            j = self.gen_range_u32(i + 1)
            items[i], items[j] = items[j], items[i]

    # --- arkworks samplers -----------------------------------------------------
    def _rand_bigint(self, n_limbs: int) -> int:
        v = 0
        for i in range(n_limbs):
            v |= self.next_u64() << (64 * i)
        return v

    def rand_fr(self) -> int:
        """ark-ff `Fr::rand`: returns the canonical value of the sampled element."""
        mask = (1 << (64 * 4 - FR_SHAVE_BITS)) - 1
        while True:
            mont = self._rand_bigint(4) & mask
            if mont < R:
                return mont * FR_MONT_R_INV % R

    def rand_fq(self) -> int:
        mask = (1 << (64 * 6 - FQ_SHAVE_BITS)) - 1
        while True:
            mont = self._rand_bigint(6) & mask
            if mont < Q:
                return mont * FQ_MONT_R_INV % Q

    def rand_g1(self) -> G1:
        """ark-ec `Projective::<G1>::rand`: hash-to-curve-by-rejection."""
        while True:
            x = self.rand_fq()
            greatest = self.gen_bool_standard()
            p = get_point_from_x(x, greatest)
            if p is not None:
                return p.mul_by_cofactor()
