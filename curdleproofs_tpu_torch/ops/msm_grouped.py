"""Grouped device MSM (torch): MANY small MSMs in ONE dispatch, the JAX
package's `ops/msm_grouped.py` stage for stage on the port's kernels.

The batched prover's folding rounds need B proofs x 4-6 MSMs of ~n/2 terms
each, every round (reference round structure:
`curdleproofs/src/inner_product_argument.rs:150-186` and
`same_multiscalar_argument.rs:99-136`).  One dispatch runs the WHOLE round,
thousands of relations, and downloads only the finished points.

Differences from the single-MSM pipeline (`ops/msm_device.py`):

- Output axis: each relation (output point) owns its own window rows and
  bucket space; window sums reduce to final points ON DEVICE with a Horner
  ladder (64 x [4 doublings + add], one thread a relation of one
  `g1_horner` launch; a doubling is the complete add of a point to itself,
  as in the reference), so the download is [3, 24, n_rel] canonical points.
- c = 4 windows (W = 64, 8 buckets).  64*4 = 256 > 255 bits, so the top
  window is always 0..7 and absorbs the signed-recode carry.
- No sort: with 8 buckets, per-entry in-bucket ranks come from a one-hot
  cumulative sum over the 8 bucket lanes.
- Indirect columns: relations address bases through a column map, so a
  composite-scalar prover can hit arbitrary strided subsets of a resident
  base set without materialising folded points.

Two modes, as in the reference:
- slot mode (`grouped_msm`): sparse relations over a `DeviceBases`
  ([P | -P | inf]): slot plan, bucket fold (`g1_fold_madd`, or
  `g1_fold_packed` with `madd=False`), slot merge (`g1_add_scan` rounds),
  bucket reduction (`g1_suffix_weighted`, which routes n_rel <= 128 to its
  tree entry on the card), Horner (`g1_horner`);
- table mode (`grouped_msm_table`): dense relations over a
  `DeviceBasesTable`, the multiples d*P for d = 1..8 precomputed once per
  residency, so every window sum is one streaming fold of `width` table
  entries and Horner: no slots, merge or reduction.

XLA ops map to torch as in `msm_device`: `.at[].set(mode="drop")` -> a write
into a buffer with one spare sink cell, then a slice; the merge loop's
`while_loop` bound -> one device-to-host read a dispatch; `lax.associative_
scan(FQ.mul)` -> a prefix product of `fq_mul` launches (every product is
reduced below q, so any order of products gives the same words).  The
reference gathers the fold's rows before its Pallas fold (`_take1`); the
port's fold gathers inside the kernel from the resident arrays and the plan.

On the CPU every kernel wrapper runs its plain version, so the same code is
the CPU reference the tests hold against the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import Q
from ..host.g1 import G1
from .field import FQ, pack_pairs, unpack_pairs
from .g1_ops import PointsXYZ, g1_add
from .kernels import (
    g1_fold_madd, g1_fold_packed, g1_horner, g1_suffix_weighted,
)
from .limbs import FQ_LIMBS as L
from .limbs import int_to_limbs
from .msm_device import (
    DeviceBases, _decode_canonical, _round_up,
    _scalar_bytes, _suffix_scan, _window_sums_to_host, use_madd,
)

__all__ = ["DeviceBasesTable", "GroupedParams", "GroupedPlan",
           "decode_points", "grouped_core", "grouped_msm", "grouped_msm_table",
           "grouped_slot_run", "grouped_table_run", "grouped_plan",
           "horner_device", "pack_relations", "pick_grouped_params",
           "signed_digits_c4", "table_plan", "upload_relations"]

_C = 4                      # window bits (see module docstring)
_W = 64                     # 64 windows x 4 bits = 256 bits >= 255
_B_CNT = 1 << (_C - 1)      # 8 buckets per window
_T = 8                      # slot depth = the fold kernel's row block


@dataclass(frozen=True)
class GroupedParams:
    """Static shape family of one grouped dispatch."""
    n_rel: int    # relations (output points), multiple of 8
    width: int    # columns per relation (padded)
    s_pad: int    # slot bound, multiple of 512
    n_ext: int    # resident base count N (ext arrays are [*, 2N+1])

    @property
    def rows(self) -> int:
        return self.n_rel * _W


def pick_grouped_params(n_rel: int, width: int, n_ext: int) -> GroupedParams:
    n_rel = _round_up(max(n_rel, 8), 8)
    rows = n_rel * _W
    # per row: <= 8 occupied buckets + ceil-overflow slots bounded by
    # (width - occupied)/T; static worst case per row
    per_row = _B_CNT + _round_up(max(0, width - _B_CNT), _T) // _T
    s_pad = _round_up(rows * per_row, 512)
    return GroupedParams(n_rel, width, s_pad, n_ext)


def signed_digits_c4(limbs: torch.Tensor, m: int) -> torch.Tensor:
    """[16, m] scalar limbs (uint16 values) -> signed base-16 digits [64, m]
    int32 in [-8, 8].  Scalars < r < 2^255, so the top window (bits
    252..255, raw digit <= 7) absorbs the final carry (7 + 1 = 8 = half,
    not > half).

    The reference's scan, without the 64-step loop: a window carries out
    exactly when its nibble plus the carry in exceeds 8, so a nibble >= 9
    always carries, one <= 7 never does, and an 8 passes its carry in on.
    The carry out of window w is therefore decided by the last window at or
    below w whose nibble is not 8 (none: no carry), found with one cummax."""
    limbs = limbs.int() & 0xFFFF
    nib = torch.stack([(limbs >> (4 * j)) & 0xF for j in range(4)],
                      dim=1).reshape(_W, m)
    pos = torch.arange(_W, device=nib.device)[:, None]
    last = torch.cummax(torch.where(nib != _B_CNT, pos, -1), dim=0).values
    cout = ((last >= 0)
            & (torch.gather(nib, 0, last.clamp(min=0)) > _B_CNT)).int()
    cin = torch.cat([torch.zeros_like(cout[:1]), cout[:-1]])
    return nib + cin - 16 * cout


# --------------------------------------------------------------------------
# slot mode
# --------------------------------------------------------------------------

@dataclass
class GroupedPlan:
    """The slot layout of one grouped dispatch."""
    plan: torch.Tensor       # [T, s_pad] int32 extended-point indices
    slot_gkey: torch.Tensor  # [s_pad] int64 (row, bucket) key of each slot
    kmax: int                # most slots any one bucket owns
    sel: torch.Tensor        # [8, rows] first slot of each (bucket, row)
    occ: torch.Tensor        # [1, 8, rows] whether that bucket holds entries


def grouped_plan(digits: torch.Tensor, col_pts: torch.Tensor,
                 params: GroupedParams) -> GroupedPlan:
    """Slot layout for digits [n_rel, W, width] in [-8, 8] over the base
    indices col_pts [n_rel, width] (`grouped_core`'s first stages): each
    (row, bucket) owns ceil(count/T) slots of T plan rows."""
    n_rel, width, s_pad = params.n_rel, params.width, params.s_pad
    rows, n_ext = params.rows, params.n_ext
    dev = digits.device
    i64 = torch.int64

    # -- bucket key + extended index per cell ------------------------------
    live = digits != 0
    key = torch.where(live, digits.abs() - 1, _B_CNT).to(i64)
    col = col_pts.to(i64)[:, None, :]
    eidx = torch.where(digits < 0, col + n_ext, col)        # [n_rel, W, wd]

    # -- ranks: rank of each live cell within its (row, bucket) ------------
    rank = torch.zeros_like(key)
    cnts = []
    for b in range(_B_CNT):
        m = key == b
        cs = torch.cumsum(m.to(i64), dim=-1)
        rank = torch.where(m, cs - 1, rank)
        cnts.append(cs[..., -1])
    cnt = torch.stack(cnts, dim=-1)                          # [n_rel, W, 8]

    # -- slot layout: bucket (row, b) owns ceil(cnt/T) slots ---------------
    slots_per_bucket = (cnt + _T - 1) // _T
    b_off = torch.cumsum(slots_per_bucket, dim=-1) - slots_per_bucket
    row_slots = slots_per_bucket.sum(dim=-1).reshape(-1)     # [rows]
    row_off = (torch.cumsum(row_slots, 0) - row_slots).reshape(n_rel, _W)

    # global slot of a cell: row base + bucket base + rank // T
    cell_boff = torch.gather(b_off, -1, key.clamp(max=_B_CNT - 1))
    gslot = row_off[..., None] + cell_boff + rank // _T

    # -- scatter-built fold plan + slot key table, one sink cell each ------
    dest = torch.where(live, (rank % _T) * s_pad + gslot, _T * s_pad)
    plan = torch.full((_T * s_pad + 1,), 2 * n_ext, dtype=torch.int32,
                      device=dev)
    plan[dest.reshape(-1)] = eidx.reshape(-1).int()
    plan = plan[:-1].reshape(_T, s_pad)
    rowid = (torch.arange(n_rel, device=dev)[:, None] * _W
             + torch.arange(_W, device=dev)[None, :])[..., None]
    sentinel = rows * _B_CNT + 9
    gkey = torch.where(live, rowid * _B_CNT + key, sentinel)
    sdest = torch.where(live, gslot, s_pad)
    # duplicates write the same value (all cells of a slot share its key)
    slot_gkey = torch.full((s_pad + 1,), sentinel, dtype=i64, device=dev)
    slot_gkey[sdest.reshape(-1)] = gkey.reshape(-1)
    slot_gkey = slot_gkey[:-1]

    # first slot per (row, bucket): bucket totals end up there after merge
    first_slot = row_off[..., None] + b_off                  # [n_rel, W, 8]
    occupied = cnt > 0
    sel = torch.where(occupied, first_slot, 0).permute(2, 0, 1) \
        .reshape(_B_CNT, rows)
    occ = occupied.permute(2, 0, 1).reshape(1, _B_CNT, rows)
    kmax = int(slots_per_bucket.max())
    return GroupedPlan(plan, slot_gkey, kmax, sel, occ)


def grouped_core(ext_px, ext_py, ext_zb, digits, col_pts, *,
                 params: GroupedParams, madd: bool = True,
                 mark=None) -> PointsXYZ:
    """Window sums for n_rel relations: digits [n_rel, W, width] int32 in
    [-8, 8], col_pts [n_rel, width] base indices in [0, n_ext) (dead
    columns: any valid index with digit 0).  Returns Montgomery window sums
    as a PointsXYZ of [24, n_rel, W] tensors.  `madd` picks the fold
    (`g1_fold_madd`, else the full-add `g1_fold_packed`); `mark(stage)`,
    when given, is called as each stage has been queued."""
    mark = mark or (lambda stage: None)
    gp = grouped_plan(digits, col_pts, params)
    mark("plan")

    # -- bucket fold (the hot kernel; shared with the single-MSM path) -----
    fold = g1_fold_madd if madd else g1_fold_packed
    acc = fold(ext_px, ext_py, ext_zb, gp.plan)
    mark("fold")

    # -- merge slots of equal (row, bucket) (masked suffix doubling scan) --
    acc = _suffix_scan(acc, gp.slot_gkey, gp.kmax)
    mark("merge")

    # -- dense buckets [24, 8, rows] + weighted suffix reduction -----------
    one_m = FQ.const(1, (1, 1), digits.device)
    dense = PointsXYZ(torch.where(gp.occ, acc.x[:, gp.sel], 0),
                      torch.where(gp.occ, acc.y[:, gp.sel], one_m),
                      torch.where(gp.occ, acc.z[:, gp.sel], 0))
    _, wsum = g1_suffix_weighted(*dense)
    mark("suffix")
    return PointsXYZ(*(c.reshape(L, params.n_rel, _W) for c in wsum))


def horner_device(wsums: PointsXYZ) -> torch.Tensor:
    """[24, n_rel, W] Montgomery window sums -> [3, 24, n_rel] CANONICAL
    projective points: acc = ((ws[W-1] * 16 + ws[W-2]) * 16 + ...), 64
    iterations of 4 doublings + 1 add, each relation's chain in one thread
    of one `g1_horner` launch on the card (a doubling adds acc to itself,
    as the reference does, so the representatives are the reference's),
    then leave-Montgomery; on the CPU its plain version."""
    return g1_horner(*wsums)


def _digits(limbs: torch.Tensor, n_rel: int, width: int) -> torch.Tensor:
    """[16, n_rel, width] scalar limbs -> digits [n_rel, W, width]."""
    m = n_rel * width
    return signed_digits_c4(limbs.reshape(16, m), m) \
        .reshape(_W, n_rel, width).permute(1, 0, 2)


def grouped_slot_run(ext_px, ext_py, ext_zb, limbs, col_pts, *,
                     params: GroupedParams, madd: bool = True,
                     mark=None) -> torch.Tensor:
    """The reference's `_grouped_msm_jit`: limbs [16, n_rel, width] canonical
    scalar limbs, col_pts [n_rel, width] -> [3, 24, n_rel] canonical
    projective results, queued on the bases' device."""
    mark = mark or (lambda stage: None)
    digits = _digits(limbs, params.n_rel, params.width)
    mark("recode")
    ws = grouped_core(ext_px, ext_py, ext_zb, digits, col_pts, params=params,
                      madd=madd, mark=mark)
    out = horner_device(ws)
    mark("horner")
    return out


def decode_points(out: np.ndarray) -> list[G1]:
    """[3, 24, n_rel] canonical projective -> host G1 list."""
    return _window_sums_to_host(out)


def pack_relations(relations, n_rel: int, width: int, n_cols: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """[(cols, scalars)] -> (limbs [16, n_rel, width] uint16, cols
    [n_rel, width] int32), dead cells and relations zero.  Scalars are
    python ints or a canonical 32 B-LE buffer; columns index the `n_cols`
    resident bases (a kernel would read past them)."""
    cols = np.zeros((n_rel, width), np.int32)
    limbs = np.zeros((n_rel, width, 16), np.uint16)
    for i, (c, s) in enumerate(relations):
        buf = _scalar_bytes(s)
        if len(buf) != 32 * len(c):
            raise ValueError(f"relation {i}: {len(c)} columns, "
                             f"{len(buf) // 32} scalars")
        cols[i, : len(c)] = c
        limbs[i, : len(c)] = np.frombuffer(buf, "<u2").reshape(-1, 16)
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError(f"a column lies outside the {n_cols} resident bases")
    return np.ascontiguousarray(limbs.transpose(2, 0, 1)), cols


def upload_relations(limbs: np.ndarray, cols: np.ndarray, device):
    """`pack_relations`' arrays as int32 limb and column tensors on
    `device`."""
    return (torch.from_numpy(limbs.astype(np.int32)).to(device),
            torch.from_numpy(cols).to(device))


def grouped_msm(bases: DeviceBases, relations, madd: bool | None = None,
                mark=None) -> list[G1]:
    """Host-facing grouped MSM: each relation is (cols, scalars) over the
    resident `bases` (cols index the ORIGINAL point list).  All relations
    run in one dispatch on the bases' device; returns one G1 per relation.
    `madd` and `mark` as in `grouped_core`; unset, `use_madd()` picks the
    fold."""
    if not relations:
        return []
    if madd is None:
        madd = use_madd()
    width = max(len(c) for c, _ in relations)
    params = pick_grouped_params(len(relations), width, bases.n)
    lt, ct = upload_relations(
        *pack_relations(relations, params.n_rel, width, bases.n),
        bases.device)
    out = grouped_slot_run(bases.ext_px, bases.ext_py, bases.ext_zb, lt, ct,
                           params=params, madd=madd, mark=mark)
    return decode_points(out.cpu().numpy())[: len(relations)]


# --------------------------------------------------------------------------
# TABLE MODE: dense relations over precomputed small multiples
# --------------------------------------------------------------------------
# The batched prover's rounds are DENSE (every row has `width` live cells)
# over bases that are resident and known in advance.  Table mode computes
# d*P for d in 1..8 for every resident base once per residency, and each
# window sum becomes a PURE STREAMING FOLD of `width` table entries: no
# buckets, no slots, no merge, no bucket reduction.

class DeviceBasesTable:
    """Extended residency [d*P | -d*P | inf] for d = 1..8 (c = 4 digits).

    Layout: column m*N + i holds (m+1) * P_i for m in 0..7; columns
    8N..16N-1 the negations (y flipped); column 16N the infinity sentinel.
    Multiples are computed on the bases' device (7 complete adds over the
    base vector + one batched z-normalisation whose single field inversion
    hops to the host: 48 B down, 48 B up)."""

    def __init__(self, bases: DeviceBases):
        self.n = bases.n
        self.n_real = bases.n_real
        self.device = bases.device
        total_dev, mx, my, mz = _table_stage1(
            bases.ext_px, bases.ext_py, bases.ext_zb)
        total = _decode_canonical(total_dev.cpu().numpy()[:, None])[0]
        # the ONE inversion of the whole batch, on the host; uploaded in
        # MONTGOMERY form so the device chain stays in-domain
        inv_mont = pow(total, Q - 2, Q) * pow(2, 384, Q) % Q
        inv = torch.from_numpy(int_to_limbs(inv_mont, L).astype(np.int32))
        self.ext_px, self.ext_py, self.ext_zb = _table_stage2(
            bases.ext_px, bases.ext_py, bases.ext_zb, mx, my, mz,
            inv.to(self.device))


def _fq_product(a: torch.Tensor) -> torch.Tensor:
    """[24, m] Montgomery residues -> [24, 1], their product (a tree of
    `fq_mul` launches)."""
    one = FQ.const(1, (1,), a.device)
    while a.shape[1] > 1:
        if a.shape[1] % 2:
            a = torch.cat([a, one], dim=1)
        a = FQ.mul(a[:, 0::2], a[:, 1::2])
    return a


def _prefix_products(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along dim 1 of [24, m] Montgomery residues
    (Hillis-Steele: log2 m rounds, one `fq_mul` launch each)."""
    s = 1
    while s < a.shape[1]:
        a = torch.cat([a[:, :s], FQ.mul(a[:, s:], a[:, :-s])], dim=1)
        s *= 2
    return a


def _table_stage1(ext_px, ext_py, ext_zb):
    """Base residency -> projective multiples 2P..8P + the z-product.

    Returns (total_z_canonical [24], mx, my, mz each [24, 7N] Montgomery
    projective).  The caller inverts total_z on the host (one 381-bit
    inversion) and feeds it to `_table_stage2`."""
    n = ext_zb.shape[0] // 2  # ext arrays are [*, 2N+1]
    dev = ext_zb.device
    x1 = unpack_pairs(ext_px[:, :n]).int()
    y1 = unpack_pairs(ext_py[:, :n]).int()
    z1 = torch.where(ext_zb[:n][None] != 0, FQ.const(1, (n,), dev), 0)
    p1 = PointsXYZ(x1, y1, z1)

    # 2P..8P: seven complete adds (the `g1_add` kernel; the reference uses
    # the plain jnp formula, whose words it gives)
    acc, steps = p1, []
    for _ in range(7):
        acc = g1_add(acc, p1)
        steps.append(acc)
    # [24, 7, N] -> [24, 7N] in multiple-major blocks (m*N + i)
    mx, my, mz = (torch.stack([s[i] for s in steps], dim=1).reshape(L, 7 * n)
                  for i in range(3))

    # product of all z's (zeros masked to 1) for Montgomery batch inversion
    live = (mz != 0).any(dim=0)
    zmask = torch.where(live[None], mz, FQ.const(1, (7 * n,), dev))
    prod = _fq_product(zmask)
    total = FQ.mul(prod, FQ.plain_const(1, (1,), dev))[:, 0]  # canonical
    return total, mx, my, mz


def _table_stage2(ext_px, ext_py, ext_zb, mx, my, mz, inv_total):
    """Normalise the projective multiples with one shared inversion
    (`inv_total`: [24] Montgomery limbs) and assemble the
    [d*P | -d*P | inf] table residency (packed limb pairs)."""
    m = mz.shape[1]
    dev = mz.device
    one = FQ.const(1, (m,), dev)
    live = (mz != 0).any(dim=0)
    zmask = torch.where(live[None], mz, one)
    # inv(z_i) = excl_prefix_i * excl_suffix_i * inv(total)
    pp = _prefix_products(zmask)
    sp = _prefix_products(zmask.flip(1)).flip(1)
    excl_pp = torch.cat([one[:, :1], pp[:, :-1]], dim=1)
    excl_sp = torch.cat([sp[:, 1:], one[:, :1]], dim=1)
    inv_z = FQ.mul(FQ.mul(excl_pp, excl_sp), inv_total[:, None])
    ax = torch.where(live[None], FQ.mul(mx, inv_z), 0)
    ay = torch.where(live[None], FQ.mul(my, inv_z), one)
    azb = live.int()

    # assemble: [P (from the base residency) | 2P..8P | negatives | inf]
    n = m // 7
    px_all = torch.cat([ext_px[:, :n], pack_pairs(ax)], dim=1)
    py_all = torch.cat([ext_py[:, :n], pack_pairs(ay)], dim=1)
    ny_all = torch.cat([pack_pairs(FQ.neg(unpack_pairs(ext_py[:, :n]))),
                        pack_pairs(FQ.neg(ay))], dim=1)
    zb_all = torch.cat([ext_zb[:n], azb])
    tpx = torch.cat([px_all, px_all, ext_px[:, -1:]], dim=1)
    tpy = torch.cat([py_all, ny_all, ext_py[:, -1:]], dim=1)
    tzb = torch.cat([zb_all, zb_all,
                     torch.zeros(1, dtype=torch.int32, device=dev)])
    return tpx, tpy, tzb


def table_plan(digits: torch.Tensor, col_pts: torch.Tensor,
               n_base: int) -> torch.Tensor:
    """The dense fold's plan [wpad, rows] int32: every (relation, window,
    position) cell maps to ONE table entry ((|d|-1)*N + col, negatives at
    +8N, dead cells and the padding up to wpad, the width rounded up to 8,
    at the sentinel 16N); column r*W + w folds relation r's window w."""
    n_rel, _, width = digits.shape
    wpad = _round_up(width, _T)
    live = digits != 0
    idx = (digits.abs() - 1) * n_base + col_pts.long()[:, None, :] \
        + torch.where(digits < 0, 8 * n_base, 0)
    plan = torch.full((n_rel, _W, wpad), 16 * n_base, dtype=torch.int32,
                      device=digits.device)
    plan[:, :, :width] = torch.where(live, idx, 16 * n_base)
    return plan.permute(2, 0, 1).reshape(wpad, n_rel * _W).contiguous()


def grouped_table_run(tpx, tpy, tzb, limbs, col_pts, *, n_rel: int,
                      width: int, n_base: int, madd: bool = True,
                      mark=None) -> torch.Tensor:
    """The reference's `_grouped_table_jit`: the dense grouped MSM over the
    multiples table.  limbs [16, n_rel, width] canonical scalar limbs,
    col_pts [n_rel, width] base indices -> [3, 24, n_rel] canonical
    projective results: one streaming fold over the position axis (`width`
    adds a window sum, the fold kernel's least), then Horner."""
    mark = mark or (lambda stage: None)
    digits = _digits(limbs, n_rel, width)
    mark("recode")
    plan = table_plan(digits, col_pts, n_base)
    mark("plan")
    fold = g1_fold_madd if madd else g1_fold_packed
    acc = fold(tpx, tpy, tzb, plan)
    mark("fold")
    out = horner_device(PointsXYZ(*(c.reshape(L, n_rel, _W) for c in acc)))
    mark("horner")
    return out


def grouped_msm_table(table: DeviceBasesTable, relations,
                      madd: bool | None = None, mark=None) -> list[G1]:
    """`grouped_msm` twin over a DeviceBasesTable (the dense fold path)."""
    if not relations:
        return []
    if madd is None:
        madd = use_madd()
    width = max(len(c) for c, _ in relations)
    n_rel = _round_up(max(len(relations), 8), 8)
    lt, ct = upload_relations(
        *pack_relations(relations, n_rel, width, table.n), table.device)
    out = grouped_table_run(table.ext_px, table.ext_py, table.ext_zb, lt, ct,
                            n_rel=n_rel, width=width, n_base=table.n,
                            madd=madd, mark=mark)
    return decode_points(out.cpu().numpy())[: len(relations)]
