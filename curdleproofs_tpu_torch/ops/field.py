"""Batched modular arithmetic over 16-bit limb tensors (torch).

LAYOUT: limb-major, as in the JAX package — field elements are [24, *batch]
int32 tensors of 16-bit limbs (limb 0 = least significant, on dim 0), in
Montgomery form with R = 2^384.  R is the JAX package's radix, so every
residue here equals the reference's residue bit for bit.

Two implementations of each multiply sit side by side:
- the plain row math below (`mul_rows` & friends) on int64 lanes.  Torch on
  the CPU has no uint32 `+`/`>>`, and int64 holds every lazy column sum
  exactly, so carries are deferred and then resolved in a few whole-tensor
  passes (`carry_rows`) instead of a 24-step ripple;
- the `fq_mul` CUDA kernel (ops/kernels.py, csrc/fq_mul.cu) on 12 x 32-bit
  limbs, which `FQ.mul` launches for a tensor on the card.

The row math takes int64 tensors of canonical limbs and is what the CPU
tests and the kernels' plain versions run.
"""

from __future__ import annotations

import functools

import torch

from ..constants import Q
from .limbs import FQ_LIMBS, LIMB_BITS, LIMB_MASK, int_to_limbs

__all__ = ["FieldSpec", "FQ", "carry_rows", "cond_sub_rows", "mul_rows",
           "limb_col", "pack_pairs", "reduce_lazy", "unpack_pairs"]

# the plain multiply keeps [2L+1, chunk] int64 columns plus row temporaries;
# chunking the lanes bounds that near 1 GB whatever the batch
_MUL_CHUNK = 1 << 20


def limb_col(x: int, n_limbs: int, device, ndim: int = 2) -> torch.Tensor:
    """Host int -> [n_limbs, 1, ...] int64 limb column (ndim dims in all),
    cached per device so the plain ops upload no constants per call."""
    return _limb_col(x, n_limbs, torch.device(device), ndim)


@functools.lru_cache(maxsize=64)
def _limb_col(x: int, n_limbs: int, device: torch.device, ndim: int):
    v = torch.as_tensor(int_to_limbs(x, n_limbs).astype("int64"),
                        device=device)
    return v.reshape(n_limbs, *([1] * (ndim - 1)))


def pack_pairs(a: torch.Tensor) -> torch.Tensor:
    """[24, *b] 16-bit limbs -> [12, *b] int32 limb PAIRS, the bit patterns
    of uint32 lo | hi << 16 (the JAX package's `_pack_rows`; one pair is one
    32-bit limb of the CUDA kernels)."""
    v = a[0::2].long() | (a[1::2].long() << LIMB_BITS)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).int()


def unpack_pairs(a: torch.Tensor) -> torch.Tensor:
    """[12, *b] limb pairs -> [24, *b] int64 16-bit limbs (`_unpack_rows`)."""
    v = a.long() & 0xFFFFFFFF
    return torch.stack([v & LIMB_MASK, v >> LIMB_BITS], dim=1).reshape(
        2 * a.shape[0], *a.shape[1:])


def _passes_for(bits: int) -> int:
    """Parallel carry passes that bring columns < 2^bits down to <= 2^16."""
    n = 1
    while bits > LIMB_BITS + 1:
        bits = max(bits - LIMB_BITS, LIMB_BITS) + 1
        n += 1
    return n


def carry_rows(cols: torch.Tensor, bits: int = LIMB_BITS + 1):
    """Exact carry propagation over [K, *b] int64 non-negative columns, each
    < 2^bits.  Returns (K canonical 16-bit limbs, final carry [*b]).

    A few parallel passes shrink every column to <= 2^16 (carries of 0/1);
    the remaining ripple is a carry-lookahead: the carry into limb k comes
    from the last limb below k that does not merely propagate (its digit is
    not 0xFFFF), found with one cummax over the limb axis."""
    x = cols
    top = torch.zeros_like(x[0])
    for _ in range(_passes_for(bits)):
        c = x >> LIMB_BITS
        top = top + c[-1]
        x = (x & LIMB_MASK) + torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    gen = x >> LIMB_BITS                     # 1 only where x == 2^16
    d = x & LIMB_MASK
    k = x.shape[0]
    pos = torch.arange(k, device=x.device).reshape(k, *([1] * (x.ndim - 1)))
    last = torch.cummax(torch.where(d != LIMB_MASK, pos, -1), dim=0).values
    cout = torch.where(last >= 0, torch.gather(gen, 0, last.clamp(min=0)), 0)
    cin = torch.cat([torch.zeros_like(cout[:1]), cout[:-1]])
    return (d + cin) & LIMB_MASK, top + cout[-1]


def reduce_lazy(cols: torch.Tensor, p: int, n_limbs: int,
                bits: int = LIMB_BITS + 1) -> torch.Tensor:
    """Lazy non-negative columns [K >= L, *b], each < 2^bits, of a value v in
    [0, 2p) -> v mod p as L canonical limbs.  v and v + (2^16L - p) are
    carried in one stacked pass; the second overflows 16L bits exactly when
    v >= p."""
    L = n_limbs
    comp = limb_col((1 << (LIMB_BITS * L)) - p, L, cols.device, cols.ndim)
    hi = torch.cat([cols[:L] + comp, cols[L:]])
    d, carry = carry_rows(torch.stack([cols, hi], dim=1), bits + 1)
    over = carry[1] + d[L:, 1].sum(dim=0)
    return torch.where((over > 0)[None], d[:L, 1], d[:L, 0])


def cond_sub_rows(rows: torch.Tensor, p: int) -> torch.Tensor:
    """rows (canonical limbs, < 2p) -> canonical < p."""
    return reduce_lazy(rows, p, rows.shape[0])


def _diag_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[L, N] x [L, N] -> [2L, N] schoolbook columns sum_{i+j=k} a_i b_j.

    L whole-row multiply-adds (row i of a times all of b lands i columns up):
    on the CPU this beats one broadcast [L, L, N] product plus a skewed sum,
    whose padding copy dominates."""
    L, n = a.shape
    cols = torch.zeros((2 * L, n), dtype=a.dtype, device=a.device)
    for i in range(L):
        cols[i:i + L] += a[i] * b
    return cols


def broadcast_shapes(*shapes) -> torch.Size:
    """`torch.broadcast_shapes`, in plain Python.  The torch function
    imports torch.fx's symbolic shapes (and sympy) at its first call, which
    a fresh process then paid inside its first kernel launch: 2.8-3.6 s on
    the H100 machine (`tools/cold_start_probe.py --first-launch`)."""
    out: list[int] = []
    for shape in shapes:
        shape = tuple(shape)
        if len(shape) > len(out):
            out[:0] = [1] * (len(shape) - len(out))
        for i, d in enumerate(shape, len(out) - len(shape)):
            if d != out[i] and d != 1 and out[i] != 1:
                raise RuntimeError(f"shapes {shapes} do not broadcast")
            if out[i] == 1:
                out[i] = d
    return torch.Size(out)


def mul_rows(a: torch.Tensor, b: torch.Tensor, p: int,
             n0_inv: int) -> torch.Tensor:
    """Montgomery product of [L, *b] int64 canonical limbs -> [L, *b]
    canonical < p (a * b * 2^-16L mod p).

    Schoolbook columns, then word-by-word Montgomery reduction with the
    carries kept lazy: step i needs only the exact low 16 bits of column i,
    which the previous step's carry-forward provides.  Every column stays
    below 2^39, far inside int64."""
    L = a.shape[0]
    batch = broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand(L, *batch).reshape(L, -1)
    b = b.expand(L, *batch).reshape(L, -1)
    n = a.shape[1]
    if n > _MUL_CHUNK:
        out = torch.cat([mul_rows(a[:, s:s + _MUL_CHUNK],
                                  b[:, s:s + _MUL_CHUNK], p, n0_inv)
                         for s in range(0, n, _MUL_CHUNK)], dim=1)
        return out.reshape(L, *batch)
    cols = torch.cat([_diag_sums(a, b), torch.zeros_like(a[:1])])  # [2L+1, N]
    p_col = limb_col(p, L, a.device)
    for i in range(L):
        m = ((cols[i] & LIMB_MASK) * n0_inv) & LIMB_MASK
        cols[i:i + L] += m[None] * p_col
        cols[i + 1] += cols[i] >> LIMB_BITS
    # (ab + mp) / 2^16L < 2p: the L+1 high columns hold it, lazily
    return reduce_lazy(cols[L:], p, L, bits=40).reshape(L, *batch)


class FieldSpec:
    """Precomputed constants + torch ops for one prime field at a limb count.

    Tensors are [L, *batch] int32 of 16-bit limbs; results come back in the
    same form.  Every op computes on int64 internally."""

    def __init__(self, modulus: int, n_limbs: int):
        import numpy as np

        self.modulus = modulus
        self.L = n_limbs
        self.mont_R = (1 << (LIMB_BITS * n_limbs)) % modulus
        self.mont_R2 = self.mont_R * self.mont_R % modulus
        self.mont_R_inv = pow(self.mont_R, -1, modulus)
        self.n0_inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.p_limbs = np.asarray(int_to_limbs(modulus, n_limbs),
                                  dtype=np.int64)
        self.one_mont = self.mont_R % modulus

    # --- host-side form conversion -----------------------------------------
    def to_mont(self, x: int) -> int:
        return x * self.mont_R % self.modulus

    def from_mont(self, x: int) -> int:
        return x * self.mont_R_inv % self.modulus

    # --- plain int64 ops (the kernels' plain versions build on these) -------
    def add64(self, a, b):
        return reduce_lazy(a + b, self.modulus, self.L)

    def sub64(self, a, b):
        """v = a - b + 2^16L as non-negative columns a + (2^16L - 1 - b) + 1,
        carried beside v + p: v's carry out is 1 exactly when a >= b (then
        its low limbs are a - b), else v + p's low limbs are a - b + p."""
        v = a + (LIMB_MASK - b) + limb_col(1, self.L, a.device, a.ndim)
        vp = v + limb_col(self.modulus, self.L, a.device, a.ndim)
        d, carry = carry_rows(torch.stack([v, vp], dim=1), bits=LIMB_BITS + 2)
        return torch.where((carry[0] == 1)[None], d[:, 0], d[:, 1])

    def neg64(self, a):
        t = limb_col(self.modulus + 1, self.L, a.device, a.ndim) \
            + (LIMB_MASK - a)
        s, _ = carry_rows(t, bits=LIMB_BITS + 2)
        return torch.where((a == 0).all(dim=0, keepdim=True), a, s)

    def mul64(self, a, b):
        return mul_rows(a, b, self.modulus, self.n0_inv)

    def mul_b3_64(self, a):
        """a * 3b = a * 12 mod p via 4 modular adds (8a + 4a), as the
        reference kernels do it."""
        a2 = self.add64(a, a)
        a4 = self.add64(a2, a2)
        a8 = self.add64(a4, a4)
        return self.add64(a8, a4)

    # --- public ops on int32 limb tensors ------------------------------------
    def add(self, a, b):
        return self.add64(a.long(), b.long()).int()

    def sub(self, a, b):
        return self.sub64(a.long(), b.long()).int()

    def neg(self, a):
        return self.neg64(a.long()).int()

    def mul(self, a, b):
        """Montgomery product a * b * R^-1 mod p; the `fq_mul` CUDA kernel for
        tensors on the card, its plain version on the CPU."""
        from .kernels import fq_mul

        return fq_mul(a, b)

    def mul_const(self, a, c: int):
        """Multiply by a host constant (canonical int), e.g. 3b = 12."""
        return self.mul(a, self.const(c, (1,) * (a.ndim - 1), a.device))

    # --- misc ------------------------------------------------------------
    def select(self, cond, a, b):
        """cond broadcastable against batch dims (no limb axis)."""
        return torch.where(cond[None], a, b)

    def zeros(self, batch_shape=(), device="cuda"):
        return torch.zeros((self.L, *batch_shape), dtype=torch.int32,
                           device=device)

    def const(self, x: int, batch_shape=(), device="cuda"):
        """Host int (canonical) -> broadcast Montgomery limb tensor."""
        return self.plain_const(self.to_mont(x), batch_shape, device)

    def plain_const(self, x: int, batch_shape=(), device="cuda"):
        """Host int (already in the wanted form) -> broadcast limb tensor."""
        limbs = torch.as_tensor(int_to_limbs(x, self.L).astype("int32"),
                                device=device)
        return limbs.reshape(self.L, *([1] * len(batch_shape))).expand(
            self.L, *batch_shape)


@functools.cache
def _fq() -> FieldSpec:
    return FieldSpec(Q, FQ_LIMBS)


FQ = _fq()
