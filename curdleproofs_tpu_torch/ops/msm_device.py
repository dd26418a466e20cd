"""On-device Pippenger MSM (torch): the JAX package's single-program pipeline,
stage for stage, with the hand-written CUDA kernels doing the point math
on the card.

Stages per MSM (`_pipeline_core`): signed-digit recode, per-window bucket
sort, slot plan, bucket fold (`g1_fold_madd` kernel, or `g1_fold_packed`
with `madd=False`), slot merge (`g1_add` kernel, one scan-step launch a
round), dense bucket layout, bucket reduction (`g1_suffix_weighted` kernel,
then `g1_add` suffix scans and the x Cb doubling chain), and the
leave-Montgomery multiply (one `fq_mul` launch over the three
coordinates).  The host uploads the 32-byte scalars (bases stay resident,
see `prepare_bases`; on the card they cross compressed and the `g1_sqrt`
kernel rebuilds y), downloads W window sums, and finishes with a W-term
Horner ladder.  `DeviceMsmStream` runs many chunks of one fixed shape
family and sums their window sums (batch verification's streamed MSM).

Shape families are the reference's: c in {8, 16}, slot depth T, slot count
s_pad (see `pick_params`), so every stage compares with the JAX pipeline.
XLA ops map to torch as: `lax.sort` -> `torch.sort(stable=True)` (the
reference does not ask for a stable sort, so entries of one bucket may fold
in another order: compare points in affine form), `lax.cummax` ->
`torch.cummax`, `.at[].set(mode="drop")` -> a write into a buffer with one
spare trash cell, then a slice, `.at[].min` -> `scatter_reduce_("amin")`.
The merge loop's bound costs one device-to-host read per MSM.

On the CPU every kernel wrapper runs its plain version, so the same code is
the CPU reference the tests hold against the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import Q, R
from ..host.g1 import G1
from ..utils.trace import span
from .device import resolve_device
from .field import FQ, pack_pairs, unpack_pairs
from .g1_ops import PointsXYZ, g1_add, g1_infinity, points_to_device
from .kernels import (
    g1_add_scan, g1_fold_madd, g1_fold_packed, g1_sqrt, g1_suffix_weighted,
)
from .limbs import FQ_LIMBS

__all__ = ["STREAM_LOGN", "DeviceBases", "DeviceMsmStream", "MsmParams",
           "msm_device", "pick_params", "prepare_bases", "stream_params",
           "use_compressed_upload", "use_madd"]

_BIG = 1 << 30  # "unwritten" sentinel for scatter-built tables


# --------------------------------------------------------------------------
# parameters / shape families
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MsmParams:
    """Static shape family of one MSM."""
    n: int        # number of (point, scalar) pairs after padding
    c: int        # window bits (8 or 16)
    t_rows: int   # slot depth T (fold loop length), multiple of 8
    s_pad: int    # slot count, multiple of 512, upper-bounds any occupancy

    @property
    def windows(self) -> int:
        return -(-255 // self.c)

    @property
    def buckets(self) -> int:
        return 1 << (self.c - 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_n(n: int) -> int:
    """Round n up to a quarter-power-of-two so at most ~4 shape families per
    octave exist (padding entries are zero scalars = dead digits)."""
    if n <= 512:
        return _round_up(n, 64)
    p = 1 << (n.bit_length() - 1)
    return _round_up(n, p // 4)


def fold_rows_for(n: int, c: int) -> int:
    """Slot depth T: deep enough that slot count (merge work) stays small,
    shallow enough that rounding waste (keys * T/2 dead adds) stays small."""
    return max(8, min(256, _round_up(max(1, n // (4 << (c - 1))), 8)))


def slot_bound(n: int, w_cnt: int, c: int, t: int) -> int:
    """Static upper bound on slot count: sum_k ceil(cnt_k/T) <= occupied +
    entries//T, padded to a multiple of 512."""
    entries = w_cnt * n
    s = min(w_cnt << (c - 1), entries) + entries // t + 1
    return _round_up(s, 512)


def pick_params(n: int, c: int | None = None, device="cuda") -> MsmParams:
    """Shape family for n points on `device`.  An unpinned c is the tune
    table's measured winner for this family on `device`'s type
    (`msm_tune.tuned_c`); untuned, the reference's switch: c = 8 below 2^19
    padded points, else 16."""
    n = pad_n(n)
    if c is None:
        from .msm_tune import tuned_c

        c = tuned_c(n, device)
    if c is None:
        c = 8 if n < (1 << 19) else 16
    if c not in (8, 16):
        raise ValueError("device MSM supports c in {8, 16} only: other widths "
                         "concentrate the top window into a few buckets")
    w = -(-255 // c)
    t = fold_rows_for(n, c)
    return MsmParams(n, c, t, slot_bound(n, w, c, t))


# --------------------------------------------------------------------------
# device-resident bases
# --------------------------------------------------------------------------

def _extend_packed(pts: PointsXYZ):
    """[P] -> packed [P | -P | inf]: (px, py) limb-pair tensors [12, 2n+1]
    plus a z liveness bit [2n+1] (every extended point has z = 1 or 0; the
    last column is the plan's dead-slot sentinel, the identity)."""
    dev = pts.x.device
    yn = FQ.neg(pts.y)
    inf = g1_infinity((1,), dev)
    px1 = pack_pairs(pts.x)
    px = torch.cat([px1, px1, pack_pairs(inf.x)], dim=1)
    py = torch.cat([pack_pairs(pts.y), pack_pairs(yn), pack_pairs(inf.y)],
                   dim=1)
    zb = (pts.z != 0).any(dim=0).int()
    zbit = torch.cat([zb, zb, torch.zeros(1, dtype=torch.int32, device=dev)])
    return px, py, zbit


def _ingest_packed_mont(pxp, pyp, zb):
    """Packed Montgomery affine limb pairs [12, n] + liveness bits [n] ->
    the extended [P | -P | inf] resident layout (negation + concat only;
    the Montgomery residues arrive ready from the native exporter)."""
    dev = pxp.device
    inf = g1_infinity((1,), dev)
    yn = pack_pairs(FQ.neg(unpack_pairs(pyp).int()))
    ext_px = torch.cat([pxp, pxp, pack_pairs(inf.x)], dim=1)
    ext_py = torch.cat([pyp, yn, pack_pairs(inf.y)], dim=1)
    ext_zb = torch.cat([zb, zb, torch.zeros(1, dtype=torch.int32, device=dev)])
    return ext_px, ext_py, ext_zb


def use_compressed_upload(device: torch.device) -> bool:
    """Upload x and a parity bit (52 B a point instead of 100) and rebuild y
    on the device, wherever the `g1_sqrt` kernel runs: on a CUDA card.
    `CURDLEPROOFS_COMPRESS=0/1` overrides, as in the reference (which
    compresses because its TPU link ran at ~14 MB/s; whether it pays over
    the card's link is measured by `chip_smoke.py`)."""
    v = os.environ.get("CURDLEPROOFS_COMPRESS")
    if v is not None:
        return v != "0"
    return device.type == "cuda"


def _ingest_compressed(pxp: torch.Tensor, meta: torch.Tensor):
    """Packed Montgomery x limb pairs [12, n] + meta bits [n] (liveness |
    canonical_y_parity << 1) -> the extended resident layout.

    y = (x^3 + b)^((q+1)/4) comes from the `g1_sqrt` kernel (its plain
    version on the CPU), is negated where its canonical parity differs from
    the wanted one (`fq_mul` by the plain 1 reads the parity), and is the
    identity's (0, 1) on dead lanes."""
    dev = pxp.device
    n = pxp.shape[1]
    y = g1_sqrt(pxp)
    live = meta & 1
    want = (meta >> 1) & 1
    lsb = FQ.mul(y, FQ.plain_const(1, (1,), dev))[0] & 1
    y = torch.where(((lsb ^ want) == 1)[None], FQ.neg(y), y)
    y = torch.where((live == 1)[None], y, FQ.const(1, (n,), dev))
    return _ingest_packed_mont(pxp, pack_pairs(y), live)


def u32_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy -> int32 tensor with the same bit patterns."""
    return torch.from_numpy(np.array(a, dtype=np.uint32)
                            .view(np.int32)).to(device)


class DeviceBases:
    """Bases uploaded once and kept resident on `device` as [P | -P | inf].

    `msm_device` accepts it in place of the point list.  The wrapped list is
    padded with the identity up to `pad_n(len(points))`, or to `n_pad` where
    the caller pins the shape family (a `pad_n` fixed point, as
    `DeviceMsmStream` chunks do); identity rows absorb the padding scalars
    (zero).  With the native runtime, one C++ batch-normalize exports the
    affine Montgomery residues as packed limb pairs (no Python bigint work
    per point): x and the parity bits alone where `use_compressed_upload`
    says so, else x and y; without it, the bigint path converts on the
    device."""

    def __init__(self, points: list[G1], device="cuda",
                 n_pad: int | None = None):
        self.device = resolve_device(device)
        self.n_real = len(points)
        if n_pad is None:
            self.n = pad_n(len(points))
        elif n_pad < len(points) or pad_n(n_pad) != n_pad:
            raise ValueError(f"n_pad = {n_pad} is not a padded shape family "
                             f"for {len(points)} points")
        else:
            self.n = n_pad
        with span("msm.bases", points=len(points)):
            self._upload(points)

    def _upload(self, points: list[G1]) -> None:
        from ..host import native

        if native.available() and points \
                and use_compressed_upload(self.device):
            px, meta = native.export_mont_x(points, self.n)
            self.ext_px, self.ext_py, self.ext_zb = _ingest_compressed(
                *(u32_to_tensor(a, self.device) for a in (px, meta)))
        elif native.available() and points:
            px, py, zb = native.export_mont_affine(points, self.n)
            self.ext_px, self.ext_py, self.ext_zb = _ingest_packed_mont(
                *(u32_to_tensor(a, self.device) for a in (px, py, zb)))
        else:
            padded = points + [G1.infinity()] * (self.n - len(points))
            self.ext_px, self.ext_py, self.ext_zb = _extend_packed(
                points_to_device(padded, self.device))

    @classmethod
    def from_resident(cls, ext_px: torch.Tensor, ext_py: torch.Tensor,
                      ext_zb: torch.Tensor, n_real: int) -> "DeviceBases":
        """Wrap an extended resident layout that already exists
        ([12, 2n+1] pairs x2, [2n+1] bits, int32 on one device)."""
        n = (ext_px.shape[1] - 1) // 2
        if ext_px.shape != (FQ_LIMBS // 2, 2 * n + 1) \
                or ext_py.shape != ext_px.shape or ext_zb.shape != (2 * n + 1,):
            raise ValueError("resident bases are [12, 2n+1] x2 and [2n+1]")
        if pad_n(n) != n or not 0 <= n_real <= n:
            raise ValueError(f"n = {n} is not a padded shape family for "
                             f"{n_real} points")
        self = cls.__new__(cls)
        self.device = ext_px.device
        self.n_real, self.n = n_real, n
        self.ext_px, self.ext_py, self.ext_zb = ext_px, ext_py, ext_zb
        return self


_BASES_CACHE: dict[tuple, tuple] = {}


def prepare_bases(points: list[G1], device="cuda") -> DeviceBases:
    """Upload bases once per list OBJECT and device, and cache them.

    Contract: the cache is keyed on `id(points)` while holding a strong
    reference to the exact list, so a given list object must not be mutated
    after being passed here (protocol code never mutates base lists: they
    are CRS fields or freshly built).  Pass a `DeviceBases` to `msm_device`
    to manage residency yourself."""
    key = _bases_key(points, device)
    hit = _BASES_CACHE.get(key)
    if hit is not None and hit[0] is points:
        return hit[1]
    db = DeviceBases(points, device)
    if len(_BASES_CACHE) > 8:  # bound the device memory the cache holds
        _BASES_CACHE.clear()
    _BASES_CACHE[key] = (points, db)
    return db


def is_resident(points: list[G1], device="cuda") -> bool:
    """Whether `prepare_bases` holds this exact list on `device` already."""
    hit = _BASES_CACHE.get(_bases_key(points, device))
    return hit is not None and hit[0] is points


def _bases_key(points: list[G1], device) -> tuple:
    return id(points), str(resolve_device(device))


def _scalar_bytes(scalars: "list[int] | bytes") -> bytes:
    """Python ints (reduced mod r) or a canonical 32 B-LE buffer (the
    verifier's fused-dedup output: no int round trip) -> the buffer."""
    if isinstance(scalars, (bytes, bytearray)):
        return bytes(scalars)
    return b"".join((s if 0 <= s < R else s % R).to_bytes(32, "little")
                    for s in scalars)


def _scalars_to_limbs(scalars: "list[int] | bytes", n_pad: int) -> np.ndarray:
    """Canonical scalars -> [16, n_pad] uint16 of 16-bit limbs (32 B each)."""
    buf = _scalar_bytes(scalars)
    n = len(buf) // 32
    le16 = np.frombuffer(buf, dtype="<u2").reshape(n, 16)
    out = np.zeros((n_pad, 16), dtype=np.uint16)
    out[:n] = le16
    return np.ascontiguousarray(out.T)


def _scalars_len(scalars: "list[int] | bytes") -> int:
    return (len(scalars) // 32 if isinstance(scalars, (bytes, bytearray))
            else len(scalars))


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

def _signed_digits(limbs: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """[16, n] scalar limbs (uint16 values) -> signed base-2^c digits [W, n]
    int32 in [-2^(c-1), 2^(c-1)].  Requires scalars < r < 2^255 so the top
    window absorbs the final carry (c=8: top raw digit <= r>>248 = 115;
    c=16: <= r>>240 = 29677, both with headroom for +1)."""
    limbs = limbs.int() & 0xFFFF
    w_cnt = -(-255 // c)
    half = 1 << (c - 1)
    if c == 16:
        raw = limbs
    else:
        raw = torch.stack([limbs & 0xFF, limbs >> 8], dim=1).reshape(w_cnt, n)
    digits = torch.empty_like(raw)
    carry = torch.zeros_like(raw[0])
    for w in range(w_cnt):
        v = raw[w] + carry
        neg = v > half
        digits[w] = torch.where(neg, v - (1 << c), v)
        carry = neg.int()
    return digits


def _phase3_chunks(c: int, w_cnt: int) -> tuple[int, int]:
    """Bucket-reduction chunking: B = G chunks x Cb buckets, with Cb <= 16
    and w_cnt*G a multiple of 512 where possible."""
    b = 1 << (c - 1)
    g = min(b, max(b // 16, 512 // max(1, w_cnt)))
    return g, b // g


def use_madd() -> bool:
    """Mixed-add fold (11-mul complete madd on the affine bases) unless
    CURDLEPROOFS_MADD=0 pins the 12-mul full-add fold for an A/B."""
    return os.environ.get("CURDLEPROOFS_MADD", "1") != "0"


@dataclass
class SlotPlan:
    """Stages 3-7: sorted bucket keys, the fold plan and the slot tables."""
    key_s: torch.Tensor        # [W, n] sorted bucket keys (b_cnt = dead)
    slots_per_w: torch.Tensor  # [W] slots each window uses
    plan: torch.Tensor         # [T, s_pad] int32 extended-point indices
    slot_gkey: torch.Tensor    # [s_pad] global bucket key of each slot
    firstmap: torch.Tensor     # [W * b_cnt] first slot of each bucket
    kmax: int                  # most slots any one bucket owns


def _slot_plan(digits: torch.Tensor, *, n: int, c: int, t_rows: int,
               s_pad: int) -> SlotPlan:
    w_cnt = digits.shape[0]
    b_cnt = 1 << (c - 1)
    wb = w_cnt * b_cnt
    dev = digits.device
    i64 = torch.int64

    # -- 3. bucket keys + extended-point indices --------------------------
    live = digits != 0
    key = torch.where(live, digits.abs() - 1, b_cnt).to(i64)
    idx = torch.arange(n, dtype=i64, device=dev)[None, :]
    eidx = torch.where(digits < 0, idx + n, idx)

    # -- 4. per-window bucket sort (stable) --------------------------------
    key_s, order = torch.sort(key, dim=1, stable=True)
    e_s = torch.gather(eidx, 1, order)
    live_s = key_s < b_cnt

    # -- 5. slot assignment: bucket owns ceil(count/T) slots of T entries --
    p = idx.expand(w_cnt, n)
    bd = torch.cat([torch.ones((w_cnt, 1), dtype=torch.bool, device=dev),
                    key_s[:, 1:] != key_s[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(bd, p, 0), dim=1).values
    r_in_run = p - run_start
    newslot = live_s & (r_in_run % t_rows == 0)
    slot_in_w = torch.cumsum(newslot.to(i64), dim=1) - 1
    slots_per_w = slot_in_w[:, -1] + 1
    w_off = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                       torch.cumsum(slots_per_w, 0)[:-1]])
    gslot = torch.where(live_s & (slot_in_w >= 0),
                        slot_in_w + w_off[:, None], -1)

    # -- 6+7. fold plan and slot tables, scatter-built into buffers with one
    #         trash cell (the reference's mode="drop") --------------------
    live_cell = live_s & (gslot >= 0)
    row = r_in_run % t_rows
    dest = torch.where(live_cell, row * s_pad + gslot, t_rows * s_pad)
    plan = torch.full((t_rows * s_pad + 1,), 2 * n, dtype=torch.int32,
                      device=dev)
    plan[dest.reshape(-1)] = e_s.reshape(-1).int()
    plan = plan[:-1].reshape(t_rows, s_pad)
    gkey = key_s + torch.arange(w_cnt, dtype=i64, device=dev)[:, None] * b_cnt
    sdest = torch.where(live_cell, gslot, s_pad)
    # duplicates write the same value (all entries of a slot share its key)
    slot_gkey = torch.full((s_pad + 1,), wb + 9, dtype=i64, device=dev)
    slot_gkey[sdest.reshape(-1)] = gkey.reshape(-1)
    slot_gkey = slot_gkey[:-1]
    # first (minimum) slot per key, for the dense-bucket gather
    kdest = torch.where(live_cell, gkey, wb)
    firstmap = torch.full((wb + 1,), _BIG, dtype=i64, device=dev)
    firstmap.scatter_reduce_(0, kdest.reshape(-1), gslot.reshape(-1), "amin")
    firstmap = firstmap[:-1]
    with span("msm.wait"):   # the merge loop's bound: a device read
        kmax = int(torch.where(live_s, r_in_run // t_rows, 0).max()) + 1
    return SlotPlan(key_s, slots_per_w, plan, slot_gkey, firstmap, kmax)


def _suffix_scan(v: PointsXYZ, key: torch.Tensor, span: int) -> PointsXYZ:
    """Masked Hillis-Steele suffix scan over [24, n] points in runs of equal
    `key` ([n] int64, each key's lanes contiguous): rounds at strides 1, 2,
    4, ... below `span`, each one `g1_add_scan` launch.  Afterwards lane i
    holds the sum of its run's lanes from i on, for runs of at most `span`
    lanes (the slot merge: a bucket's slots; the suffix over chunks: a
    window's G chunks)."""
    stride = 1
    while stride < span:
        v = g1_add_scan(v, key, stride)
        stride *= 2
    return v


def _dense_buckets(acc: PointsXYZ, firstmap: torch.Tensor, c: int,
                   w_cnt: int) -> PointsXYZ:
    """The merged slots [24, s_pad] as the reduction's dense buckets
    [24, Cb, W*G]: [:, j, w*G + g] holds bucket g*Cb + j of window w, the
    point of its first slot (`firstmap`), or infinity where it is empty."""
    b_cnt = 1 << (c - 1)
    g_chunks, cb = _phase3_chunks(c, w_cnt)
    wg = w_cnt * g_chunks
    dev = acc.x.device
    s_pad = acc.x.shape[1]
    j_i = torch.arange(cb, device=dev)[:, None]
    wg_i = torch.arange(wg, device=dev)[None, :]
    kk = (wg_i // g_chunks) * b_cnt + (wg_i % g_chunks) * cb + j_i
    sel = firstmap[kk]                                     # [cb, wg]
    occ = (sel < _BIG)[None]
    sel_c = torch.clamp(sel, max=s_pad - 1)
    one_m = FQ.const(1, (1, 1), dev)
    return PointsXYZ(torch.where(occ, acc.x[:, sel_c], 0),
                     torch.where(occ, acc.y[:, sel_c], one_m),
                     torch.where(occ, acc.z[:, sel_c], 0))


def _pipeline_core(ext_px, ext_py, ext_zb, digits, *, n, c, t_rows, s_pad,
                   madd=True, mark=None, to_canonical=True):
    """Window sums for the windows of signed digits [W, n] over the extended
    points [P | -P | inf] -> [3, 24, W] canonical projective.  `madd` picks
    the fold (`g1_fold_madd`, else the full-add `g1_fold_packed`).
    `mark(stage)`, when given, is called as each stage has been queued (a
    caller records CUDA events there).  `to_canonical=False` returns the
    window sums in Montgomery form, [3, 24, W], so that a caller can go on
    adding them (the sharded MSM's butterfly) before leaving the domain."""
    mark = mark or (lambda stage: None)
    w_cnt = digits.shape[0]
    g_chunks, cb = _phase3_chunks(c, w_cnt)
    wg = w_cnt * g_chunks
    dev = digits.device

    sp = _slot_plan(digits, n=n, c=c, t_rows=t_rows, s_pad=s_pad)
    mark("plan")

    # -- 8. bucket fold (the hot kernel) -----------------------------------
    fold = g1_fold_madd if madd else g1_fold_packed
    acc = fold(ext_px, ext_py, ext_zb, sp.plan)
    mark("fold")

    # -- 9. merge slots of equal bucket (masked Hillis-Steele suffix scan) --
    acc = _suffix_scan(acc, sp.slot_gkey, sp.kmax)
    mark("merge")

    # -- 10. dense buckets, laid out [24, Cb, W*G] for the reduction -------
    dense = _dense_buckets(acc, sp.firstmap, c, w_cnt)
    mark("dense")

    # -- 11. bucket reduction: sum_b (b+1) * bucket_b per window -----------
    tg, lw = g1_suffix_weighted(*dense)
    mark("suffix")

    # Hillis-Steele suffix over chunks g within each window:
    # U_g = sum_{h>=g} T_h (a window's G chunks share the key w; lane
    # g + stride is in the same window exactly when g + stride < G)
    wkey = torch.arange(wg, device=dev) // g_chunks

    def at_g0(v: PointsXYZ) -> PointsXYZ:
        return PointsXYZ(*(a.reshape(-1, w_cnt, g_chunks)[..., 0] for a in v))

    u = _suffix_scan(tg, wkey, g_chunks)
    usum = at_g0(_suffix_scan(u, wkey, g_chunks))
    lwsum = at_g0(_suffix_scan(lw, wkey, g_chunks))
    u0 = at_g0(u)
    # sum_g g*T_g = sum_{g>=1} U_g = usum - u0 ; window = lwsum + Cb*(that)
    s2 = g1_add(usum, PointsXYZ(u0.x, FQ.neg(u0.y), u0.z))
    k = cb
    while k > 1:
        s2 = g1_add(s2, s2)
        k //= 2
    wsum = g1_add(lwsum, s2)
    mark("reduce")

    if not to_canonical:
        return torch.stack(tuple(wsum))
    out = _leave_montgomery(wsum)
    mark("leave_mont")
    return out


def _leave_montgomery(wsum: PointsXYZ) -> torch.Tensor:
    """[24, W] x3 Montgomery -> [3, 24, W] canonical (mul by plain 1 =
    mont-reduce): the three coordinates side by side, [24, 3W], in one
    product."""
    w = wsum.x.shape[1]
    one_plain = FQ.plain_const(1, (1,), wsum.x.device)
    out = FQ.mul(torch.cat(tuple(wsum), dim=1), one_plain)
    return out.reshape(FQ_LIMBS, 3, w).transpose(0, 1)


def _msm_pipeline(bases: "DeviceBases", limbs: np.ndarray,
                  params: MsmParams, mark=None, madd=True) -> torch.Tensor:
    """[16, n] uint16 scalar limbs -> [3, 24, W] canonical window sums."""
    mark = mark or (lambda stage: None)
    with span("msm.upload"):
        lt = torch.from_numpy(limbs.astype(np.int32)).to(bases.device)
    mark("upload")
    with span("msm.enqueue"):
        digits = _signed_digits(lt, params.n, params.c)
        mark("recode")
        return _pipeline_core(bases.ext_px, bases.ext_py, bases.ext_zb,
                              digits, n=params.n, c=params.c,
                              t_rows=params.t_rows, s_pad=params.s_pad,
                              madd=madd, mark=mark)


def _dispatch_pipeline(bases: "DeviceBases", scalars: "list[int] | bytes",
                       params: MsmParams, mark=None,
                       madd=True) -> torch.Tensor:
    """Queue one pipeline run; returns the device's [3, 24, W] window sums
    without waiting for them."""
    with span("msm.scalars"):
        limbs = _scalars_to_limbs(scalars, params.n)
    return _msm_pipeline(bases, limbs, params, mark, madd=madd)


# --------------------------------------------------------------------------
# host wrapper
# --------------------------------------------------------------------------

def _decode_canonical(arr: np.ndarray) -> list[int]:
    """[L, S] canonical 16-bit limbs -> python ints."""
    a = np.asarray(arr).astype(np.uint16).T  # [S, L] little-endian halfwords
    rows = np.ascontiguousarray(a).view(np.uint8)
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def _window_sums_to_host(out: np.ndarray) -> list[G1]:
    """[3, 24, W] canonical projective -> host G1 list."""
    from ..host.field import batch_inversion

    xs = _decode_canonical(out[0])
    ys = _decode_canonical(out[1])
    zs = _decode_canonical(out[2])
    zinvs = batch_inversion(zs, Q)
    pts = []
    for x, y, z, zi in zip(xs, ys, zs, zinvs):
        if z == 0:
            pts.append(G1.infinity())
        else:
            pts.append(G1.from_affine(x * zi % Q, y * zi % Q))
    return pts


def msm_device(points: "list[G1] | DeviceBases",
               scalars: "list[int] | bytes", c: int | None = None,
               device="cuda", mark=None, madd: bool | None = None) -> G1:
    """Device MSM: one pipeline run + a W-term host Horner ladder.

    `points` may be a DeviceBases (its own device wins) or a plain list
    (uploaded to `device` through the `prepare_bases` id-cache).  `scalars`
    may be python ints or canonical 32 B-LE raw bytes.  `mark(stage)` is
    called after each pipeline stage is queued (see `_pipeline_core`).
    `madd=False` folds with the 12-mul full add (`g1_fold_packed`) instead
    of the 11-mul mixed add on the affine bases; unset, `use_madd()`
    decides."""
    if madd is None:
        madd = use_madd()
    if isinstance(points, DeviceBases):
        bases = points
        n_real = bases.n_real
    else:
        n_real = len(points)
        if n_real == 0:
            return G1.infinity()
        bases = prepare_bases(points, device)
    if _scalars_len(scalars) != n_real:
        raise ValueError("points/scalars length mismatch")
    # pad_n fixed point: params.n == bases.n
    params = pick_params(bases.n, c, bases.device)
    if params.n != bases.n:
        raise ValueError("bases padded under a different shape family")
    out = _dispatch_pipeline(bases, scalars, params, mark, madd)
    with span("msm.wait"):
        host = out.cpu().numpy()
    with span("msm.horner"):
        return _horner_windows(_window_sums_to_host(host), params.c)


def _horner_windows(win: list[G1], c_bits: int) -> G1:
    """Window sums -> result: sum_w 2^(c*w) * win[w]."""
    from ..host import native

    if native.available() and len(win) >= 2:
        return native.msm(win, [1 << (c_bits * w) for w in range(len(win))])
    acc = G1.infinity()
    for w in range(len(win) - 1, -1, -1):
        for _ in range(c_bits):
            acc = acc.double()
        acc = acc.add(win[w])
    return acc


# --------------------------------------------------------------------------
# streamed MSM (batch verification)
# --------------------------------------------------------------------------

STREAM_LOGN = 16  # the streamed-batch chunk family: n = 2^16 per dispatch


def stream_params(c: int | None = None, device="cuda") -> MsmParams:
    """The one fixed shape family every default `DeviceMsmStream` dispatch
    on `device` uses, whatever sizes `add()` receives."""
    return pick_params(1 << STREAM_LOGN, c, device)


class DeviceMsmStream:
    """Pipelined many-chunk MSM on `device`: `add()` buffers terms and
    dispatches one pipeline run per FULL chunk of `params.n` terms;
    `result()` dispatches the tail, waits, and returns the MSM of every term
    added so far.

    MSM(all) = sum_k MSM(chunk_k) because Pippenger window sums are
    additive, so chunks combine with W host point-adds each, and the device
    crunches chunk k while the host prepares chunk k+1.  Every dispatch
    shares one shape family whatever sizes `add()` receives.

    With `async_worker=True` the dispatches (base export, ingest, scalar
    upload, pipeline) run on a worker thread, on PyTorch's current stream
    for `device` in that thread; the merge loop's bound read waits there,
    not in the caller.  A dispatch that raises stops the stream: later
    chunks are drained unrun, and `result()` raises that error, now and on
    every later call, so no partial sum is ever returned.  After `result()`
    the stream stays usable: a later `add()` starts a new worker.

    `mark(stage)`, when given, is called at the start of each dispatch
    ("start"), once its bases are resident ("ingest"), and after each
    pipeline stage is queued (see `_pipeline_core`); `madd` picks the fold
    as in `msm_device`."""

    def __init__(self, n_chunk: int | None = None, c: int | None = None,
                 async_worker: bool = False, device="cuda", mark=None,
                 madd: bool | None = None):
        self.device = resolve_device(device)
        self.params = (stream_params(c, self.device) if n_chunk is None
                       else pick_params(n_chunk, c, self.device))
        self.mark = mark
        self.madd = use_madd() if madd is None else madd
        self._async = async_worker
        self._outs: list[torch.Tensor] = []
        self._pts: list[G1] = []
        self._sc = bytearray()
        self._q = None
        self._thread = None
        self._error: BaseException | None = None

    @property
    def dispatches(self) -> int:
        """Pipeline runs finished or queued so far."""
        return len(self._outs)

    def _worker(self, q) -> None:
        while True:
            job = q.get()
            if job is None:
                return
            if self._error is not None:
                continue  # drain: the producer never blocks on a dead worker
            try:
                self._dispatch(*job)
            except BaseException as e:  # noqa: BLE001 - raised in result()
                self._error = e

    def add(self, points: list[G1], scalars: "list[int] | bytes") -> None:
        if len(points) != _scalars_len(scalars):
            raise ValueError("points/scalars length mismatch")
        self._pts.extend(points)
        self._sc += _scalar_bytes(scalars)
        n = self.params.n
        while len(self._pts) >= n:
            self._submit(self._pts[:n], bytes(self._sc[: n * 32]))
            del self._pts[:n]
            del self._sc[: n * 32]

    def _submit(self, pts: list[G1], sc: bytes) -> None:
        if not self._async:
            self._dispatch(pts, sc)
            return
        if self._thread is None:
            import contextvars
            import queue
            import threading

            self._q = queue.Queue(maxsize=4)
            # the worker runs in the submitter's context: its spans keep
            # the submitting call's id
            self._thread = threading.Thread(
                target=contextvars.copy_context().run,
                args=(self._worker, self._q), daemon=True)
            self._thread.start()
        self._q.put((pts, sc))

    def _dispatch(self, pts: list[G1], sc: bytes) -> None:
        mark = self.mark or (lambda stage: None)
        mark("start")
        bases = DeviceBases(pts, self.device, n_pad=self.params.n)
        mark("ingest")
        self._outs.append(_dispatch_pipeline(bases, sc, self.params, mark,
                                             self.madd))

    def result(self) -> G1:
        if self._pts:
            self._submit(self._pts, bytes(self._sc))
            self._pts, self._sc = [], bytearray()
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread, self._q = None, None
        if self._error is not None:
            raise self._error
        with span("msm.wait"):
            outs = [out.cpu().numpy() for out in self._outs]
        if not outs:
            return G1.infinity()
        with span("msm.horner"):
            wins = _window_sums_to_host(outs[0])
            for out in outs[1:]:
                wins = [a.add(b)
                        for a, b in zip(wins, _window_sums_to_host(out))]
            return _horner_windows(wins, self.params.c)
