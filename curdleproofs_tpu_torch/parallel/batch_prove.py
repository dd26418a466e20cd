"""Lockstep batched prover: B shuffle proofs, one device dispatch per round
(the JAX package's `parallel/batch_prove.py`, its device half on the port's
grouped MSM).

The folding rounds of B independent proofs are round-synchronous: every
proof is at round k at the same time, so all B proofs' round-k L/R
commitments (4 MSMs each in the IPA, 6 in the same-multiscalar argument;
reference round structure `curdleproofs/src/inner_product_argument.rs:150-186`
and `same_multiscalar_argument.rs:99-136`) batch into ONE grouped device
dispatch (`ops/msm_grouped.py`): about 20 dispatches for the whole batch.

Two design moves make the rounds device-friendly:

1. **Composite scalars instead of folded bases.**  The sequential prover
   folds its base vectors every round (G <- G_L + gamma*G_R, n/2 point muls
   per round, `curdleproofs/src/inner_product_argument.rs:170-179`).  Here
   bases stay RESIDENT and UNFOLDED on the device; a folded base expands as
       G^(k)[i] = sum_j w_j * G_orig[i + j*n_k],   w interleaved per round
       (w <- [w, gamma*w]),
   so every round-k MSM of m = n/2^k folded terms becomes an MSM of exactly
   n/2 ORIGINAL-base terms with composite scalars (witness x weight outer
   products, chained natively).  No point ever folds; the per-round device
   work is constant across rounds and always hits the grouped pipeline's
   dense regime.

2. **One resident base set for the whole batch.**  The CRS vectors are
   shared by every proof; the per-proof R/S/T/U vectors upload once (on the
   card compressed, x and a parity bit a point) into a single
   `DeviceBases`, and relations address them through the grouped
   pipeline's indirect column map.

The device is the active `TorchBackend`'s, as for batch verification's
stream (`ops/backend.py::active_device`); under any other backend it is
`cuda`, which raises without a card.  `CURDLEPROOFS_TABLE=0` pins the slot
mode of the grouped MSM, else table mode runs; `madd=False` folds with the
full add (`g1_fold_packed`); left unset, `use_madd()` reads
`CURDLEPROOFS_MADD`.

Bit-exactness: per-proof transcripts and ChaCha12 RNG draws advance in
exactly the sequential order, so `batch_prove` output proofs serialize
byte-identically to `CurdleproofsProof.new` run one at a time
(tests/test_torch_batch_prove.py pins this).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..commitments import GroupCommitment
from ..constants import N_BLINDERS, R
from ..crs import CurdleproofsCrs
from ..curdleproofs import CurdleproofsProof
from ..grand_product import GrandProductProof
from ..host.field import fr_inv, fr_pow
from ..host.g1 import G1
from ..host.rng import StdRng
from ..ipa import InnerProductProof
from ..ops.backend import active_device
from ..ops.msm_device import DeviceBases, use_madd
from ..ops.msm_grouped import (
    DeviceBasesTable, decode_points, grouped_slot_run, grouped_table_run,
    pack_relations, pick_grouped_params, upload_relations,
)
from ..same_msm import SameMultiscalarProof
from ..same_permutation import SamePermutationProof
from ..same_scalar import SameScalarProof
from ..transcript import Transcript, _points_payload
from ..util import get_permutation, inner_product
from ..utils.trace import span

__all__ = ["ProveInstance", "batch_prove"]


@dataclass
class ProveInstance:
    """One shuffle-proof witness (the argument list of
    `CurdleproofsProof.new`, `curdleproofs/src/curdleproofs.rs:59-71`)."""
    vec_R: list[G1]
    vec_S: list[G1]
    vec_T: list[G1]
    vec_U: list[G1]
    M: G1
    permutation: list[int]
    k: int
    vec_m_blinders: list[int]
    rng: StdRng


# --------------------------------------------------------------------------
# Fr bulk chains (native fast path, python fallback = the spec)
# --------------------------------------------------------------------------

def _native():
    try:
        from ..host import native

        return native if native.available() else None
    except Exception:
        return None


def ints_to_raw(xs: list[int]) -> bytes:
    return b"".join((x % R).to_bytes(32, "little") for x in xs)


def raw_to_ints(b: bytes) -> list[int]:
    return [int.from_bytes(b[i:i + 32], "little") for i in range(0, len(b), 32)]


def fr_outer(a: bytes, b: bytes) -> bytes:
    """out[i*nb+j] = a[i]*b[j] mod r (canonical 32 B-LE buffers)."""
    nat = _native()
    if nat is not None:
        return nat.fr_outer_raw(a, b)
    av, bv = raw_to_ints(a), raw_to_ints(b)
    return ints_to_raw([x * y % R for x in av for y in bv])


def fr_axpy(gamma: int, x: bytes, y: bytes) -> bytes:
    """out[i] = x[i] + gamma*y[i] mod r."""
    nat = _native()
    if nat is not None:
        return nat.fr_axpy_raw(gamma, x, y)
    xv, yv = raw_to_ints(x), raw_to_ints(y)
    return ints_to_raw([(a + gamma * b) % R for a, b in zip(xv, yv)])


def fr_mul_vec(a: bytes, b: bytes) -> bytes:
    nat = _native()
    if nat is not None:
        return nat.fr_mul_vec_raw(a, b)
    return ints_to_raw([x * y % R
                        for x, y in zip(raw_to_ints(a), raw_to_ints(b))])


def fr_inner2(a: bytes, b: bytes, n: int) -> list[int]:
    """Inner products of consecutive n-blocks: [<a0,b0>, <a1,b1>, ...]."""
    nat = _native()
    if nat is not None:
        return nat.fr_inner_many_raw(a, b, n)
    av, bv = raw_to_ints(a), raw_to_ints(b)
    return [sum(av[k * n + i] * bv[k * n + i] for i in range(n)) % R
            for k in range(len(av) // n)]


def fr_scale_raw(rf: int, xs: bytes) -> bytes:
    nat = _native()
    if nat is not None:
        return nat.fr_scale_raw(rf, xs)
    return ints_to_raw([rf * x % R for x in raw_to_ints(xs)])


def fr_prefix_prod(xs: bytes) -> bytes:
    """Exclusive prefix products [1, x0, x0*x1, ...] mod r."""
    nat = _native()
    if nat is not None:
        return nat.fr_prefix_prod_raw(xs)
    out, acc = [], 1
    for x in raw_to_ints(xs):
        out.append(acc)
        acc = acc * x % R
    return ints_to_raw(out)


def fr_powers_raw(base: int, n: int) -> bytes:
    nat = _native()
    if nat is not None:
        return nat.fr_powers_raw(base, n)
    out, acc = [], 1
    for _ in range(n):
        acc = acc * base % R
        out.append(acc)
    return ints_to_raw(out)


def _interleave(w: bytes, gw: bytes) -> bytes:
    """[w_0, g*w_0, w_1, g*w_1, ...] — the per-round weight update."""
    a = np.frombuffer(w, np.uint8).reshape(-1, 32)
    b = np.frombuffer(gw, np.uint8).reshape(-1, 32)
    return np.stack([a, b], axis=1).reshape(-1, 32).tobytes()


# --------------------------------------------------------------------------
# grouped-dispatch plumbing
# --------------------------------------------------------------------------

def use_table() -> bool:
    """Table mode (precomputed d*P multiples, streaming fold — see
    ops/msm_grouped.py) unless CURDLEPROOFS_TABLE=0 pins the slot path."""
    return os.environ.get("CURDLEPROOFS_TABLE", "1") != "0"


class _Dispatcher:
    """Pack (cols, raw-scalar) relations into one grouped device dispatch.

    Each dispatch is a `prove.dispatch` span; its stages' spans add their
    seconds to `timings` (given, or a dict of its own): `pack_s`,
    `device_s` (upload, run and download, its `dispatch.wait` the download's
    wait on the card) and `decode_s`, and the table build `table_s` (within
    the caller's `bases_s`).  `mark(stage)`, when given, reaches the grouped
    MSM's stages and is called with "start" as each dispatch begins."""

    def __init__(self, bases: DeviceBases, madd: bool | None = None,
                 mark=None, timings: dict | None = None):
        self.bases = bases
        self.madd = use_madd() if madd is None else madd
        self.mark = mark or (lambda stage: None)
        self.timings: dict[str, float] = {} if timings is None else timings
        self.table = None
        if use_table():
            with span("prove.table", acc=self.timings, key="table_s"):
                self.table = DeviceBasesTable(bases)
                _sync(bases.device)

    def run(self, rels: "list[tuple[np.ndarray, bytes]]") -> list[G1]:
        """rels: [(cols int32 [w], scalars raw 32 B-LE [w*32])] -> [G1]."""
        tm = self.timings
        with span("prove.dispatch", timeline=False, relations=len(rels)):
            with span("dispatch.pack", acc=tm, key="pack_s", timeline=False):
                self.mark("start")
                width = max(len(c) for c, _ in rels)
                params = pick_grouped_params(len(rels), width, self.bases.n)
                limbs, cols = pack_relations(rels, params.n_rel, width,
                                             self.bases.n)
            with span("dispatch.device", acc=tm, key="device_s", timeline=False):
                lt, ct = upload_relations(limbs, cols, self.bases.device)
                self.mark("upload")
                if self.table is not None:
                    t = self.table
                    out = grouped_table_run(
                        t.ext_px, t.ext_py, t.ext_zb, lt, ct,
                        n_rel=params.n_rel, width=width, n_base=t.n,
                        madd=self.madd, mark=self.mark)
                else:
                    b = self.bases
                    out = grouped_slot_run(
                        b.ext_px, b.ext_py, b.ext_zb, lt, ct, params=params,
                        madd=self.madd, mark=self.mark)
                with span("dispatch.wait", timeline=False):
                    host = out.cpu().numpy()
            with span("dispatch.decode", acc=tm, key="decode_s", timeline=False):
                pts = decode_points(host)[: len(rels)]
        tm["dispatches"] = tm.get("dispatches", 0) + 1
        return pts


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work, so a host timing holds it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _round_maps(n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per round k: (posL, posR) composite POSITION maps of length n/2.

    posL[i*2^(k-1)+j] = i + j*n_k covers the left-half folded bases'
    original positions; posR the right half (i + n_k/2 + j*n_k)."""
    maps = []
    n_k = n
    j = np.arange(1, dtype=np.int64)
    while n_k > 1:
        h = n_k // 2
        i = np.arange(h, dtype=np.int64)
        pl = (i[:, None] + j[None, :] * n_k).reshape(-1).astype(np.int32)
        pr = pl + h
        maps.append((pl, pr))
        n_k = h
        j = np.arange(2 * len(j), dtype=np.int64)
    return maps


# --------------------------------------------------------------------------
# the lockstep prover
# --------------------------------------------------------------------------

def batch_prove(crs: CurdleproofsCrs, instances: list[ProveInstance],
                wave: int | None = None, madd: bool | None = None,
                mark=None) -> list[CurdleproofsProof]:
    """Prove all instances with per-round grouped device dispatches on the
    active backend's device (see the module docstring).

    Proof bytes are identical to sequential `CurdleproofsProof.new` calls
    with the same per-instance RNGs.  `wave` bounds how many proofs share
    one device residency (default: all, capped at 256).  `madd=False` folds
    with the full add (unset: `use_madd()`); `mark(stage)` reaches each
    dispatch's stages (see
    `_Dispatcher`)."""
    if not instances:
        return []
    wave = min(wave or 256, len(instances))
    out: list[CurdleproofsProof] = []
    for lo in range(0, len(instances), wave):
        out.extend(_prove_wave(crs, instances[lo: lo + wave], madd, mark))
    return out


def _prove_wave(crs: CurdleproofsCrs, insts: list[ProveInstance],
                madd: bool | None = None,
                mark=None) -> list[CurdleproofsProof]:
    timings: dict[str, float] = {}
    with span("prove.wave", acc=timings, key="wave_s", proofs=len(insts)):
        proofs = _wave_steps(crs, insts, madd, mark, timings)
    timings["host_other_s"] = timings["wave_s"] - sum(
        timings.get(k, 0.0)
        for k in ("bases_s", "pack_s", "device_s", "decode_s"))
    batch_prove.last_timings = dict(timings)  # the last wave's stage times
    return proofs


def _wave_steps(crs: CurdleproofsCrs, insts: list[ProveInstance],
                madd: bool | None, mark,
                timings: dict) -> list[CurdleproofsProof]:
    """One wave's steps, each a span under `prove.wave`; the dispatch
    stages' seconds go to `timings` (see `_Dispatcher`)."""
    device = active_device()
    B = len(insts)
    ell = len(crs.vec_G)
    n = ell + N_BLINDERS
    assert n & (n - 1) == 0, "ell + 4 must be a power of two"
    lg_n = n.bit_length() - 1

    # ---- resident bases: CRS + per-proof R/S/T/U, one upload --------------
    with span("prove.bases", acc=timings, key="bases_s"):
        G_off, H_off = 0, ell
        H_idx, Gt_idx, Gu_idx, INF = ell + 4, ell + 5, ell + 6, ell + 7
        combined: list[G1] = (list(crs.vec_G) + list(crs.vec_H)
                              + [crs.H, crs.G_t, crs.G_u, G1.infinity()])
        r_off, s_off, t_off, u_off = [], [], [], []
        for inst in insts:
            for off, vec in ((r_off, inst.vec_R), (s_off, inst.vec_S),
                             (t_off, inst.vec_T), (u_off, inst.vec_U)):
                off.append(len(combined))
                combined.extend(vec)
        bases = DeviceBases(combined, device)
        _sync(device)
        disp = _Dispatcher(bases, madd, mark, timings)

    with span("prove.setup"):
        # position -> column maps (n-long base vectors of the sub-arguments)
        acols = np.concatenate([np.arange(G_off, G_off + ell, dtype=np.int32),
                                np.arange(H_off, H_off + 4, dtype=np.int32)])
        gcols = np.concatenate([np.arange(G_off, G_off + ell, dtype=np.int32),
                                np.array([H_off, H_off + 1, Gt_idx, Gu_idx],
                                         np.int32)])
        tcols = [np.concatenate([np.arange(t, t + ell, dtype=np.int32),
                                 np.array([INF, INF, H_idx, INF], np.int32)])
                 for t in t_off]
        ucols = [np.concatenate([np.arange(u, u + ell, dtype=np.int32),
                                 np.array([INF, INF, INF, H_idx], np.int32)])
                 for u in u_off]
        rounds = _round_maps(n)

        # ---- per-proof host state -------------------------------------------
        # RNG draws happen here in the exact sequential order (they depend on
        # nothing downstream): a_blinders(2), c_blinders(4), ipa_r(n),
        # ipa_z(n-2), r_t, r_u, r_a, r_b, r_k, msm_r(n).
        ts: list[Transcript] = []
        vec_a_l: list[list[int]] = []
        a_perm_l: list[list[int]] = []
        tu_bodies: list[tuple[bytes, bytes]] = []
        dr: list[dict] = []
        for inst in insts:
            t = Transcript(b"curdleproofs")
            for vec in (inst.vec_R, inst.vec_S, inst.vec_T, inst.vec_U):
                t.append_point_vec(b"curdleproofs_step1", vec)
            # keep the joined T/U bodies for the same-msm step-1 appends (the
            # transcript's payload memo is bounded and would recompute them)
            tu_bodies.append((_points_payload(inst.vec_T)[8:],
                              _points_payload(inst.vec_U)[8:]))
            t.append_point(b"curdleproofs_step1", inst.M)
            vec_a = t.get_and_append_challenges(b"curdleproofs_vec_a", ell)
            ts.append(t)
            vec_a_l.append(vec_a)
            a_perm_l.append(get_permutation(vec_a, inst.permutation))
            g = inst.rng
            dr.append(dict(
                a_blinders=[g.rand_fr() for _ in range(N_BLINDERS - 2)],
                c_blinders=[g.rand_fr() for _ in range(N_BLINDERS)],
                ipa_r=[g.rand_fr() for _ in range(n)],
                ipa_z=[g.rand_fr() for _ in range(n - 2)],
                r_t=g.rand_fr(), r_u=g.rand_fr(),
                r_a=g.rand_fr(), r_b=g.rand_fr(), r_k=g.rand_fr(),
                msm_r=[g.rand_fr() for _ in range(n)]))

        # ---- dispatch 1: A commitments + R-hat/S-hat ------------------------
        rels = []
        for b in range(B):
            a_raw = ints_to_raw(vec_a_l[b])
            rels.append((acols, ints_to_raw(
                a_perm_l[b] + dr[b]["a_blinders"] + [0, 0])))
            rels.append((np.arange(r_off[b], r_off[b] + ell, dtype=np.int32),
                         a_raw))
            rels.append((np.arange(s_off[b], s_off[b] + ell, dtype=np.int32),
                         a_raw))
        d1 = disp.run(rels)
        A_l = [d1[3 * b] for b in range(B)]
        Rhat = [d1[3 * b + 1] for b in range(B)]
        Shat = [d1[3 * b + 2] for b in range(B)]

        # ---- same-permutation + grand-product setup (host) ------------------
        B_l, gprod_l, factors_l, bb_l = [], [], [], []
        for b in range(B):
            t = ts[b]
            t.append_points(b"same_perm_step1", [A_l[b], insts[b].M])
            t.append_fr_vec(b"same_perm_step1", vec_a_l[b])
            alpha = t.get_and_append_challenge(b"same_perm_alpha")
            beta = t.get_and_append_challenge(b"same_perm_beta")
            perm = insts[b].permutation
            factors = [(a + m * alpha + beta) % R
                       for a, m in zip(a_perm_l[b], perm)]
            gp = 1
            for f in factors:
                gp = gp * f % R
            B_pt = A_l[b].add(_msm3([insts[b].M, crs.G_sum], [alpha, beta]))
            r_a_prime = dr[b]["a_blinders"] + [0, 0]
            m_blinders = insts[b].vec_m_blinders
            vec_b_blinders = [(r_a_prime[i] + alpha * m_blinders[i]) % R
                              for i in range(N_BLINDERS)]
            t.append_point(b"gprod_step1", B_pt)
            t.append_fr(b"gprod_step1", gp)
            dr[b]["gp_alpha"] = t.get_and_append_challenge(b"gprod_alpha")
            B_l.append(B_pt)
            gprod_l.append(gp)
            factors_l.append(factors)
            bb_l.append(vec_b_blinders)

        # ---- dispatch 2: grand-product C commitments ------------------------
        vec_c_l = []
        factors_raw_l = []
        rels = []
        for b in range(B):
            # vec_c = exclusive prefix products of the factors (native chain)
            factors_raw = ints_to_raw(factors_l[b])
            vec_c_raw = fr_prefix_prod(factors_raw)
            factors_raw_l.append(factors_raw)
            vec_c_l.append(vec_c_raw)
            rels.append((acols,
                         vec_c_raw + ints_to_raw(dr[b]["c_blinders"])))
        C_l = disp.run(rels)

        # ---- grand-product step 2/3 (host) + IPA witness --------------------
        one32 = (1).to_bytes(32, "little")
        ones_ell = one32 * ell
        ipa_state: list[dict] = []
        for b in range(B):
            t, d = ts[b], dr[b]
            alpha = d["gp_alpha"]
            rbpa = [(r + alpha) % R for r in bb_l[b]]
            r_p = inner_product(rbpa, d["c_blinders"])
            t.append_point(b"gprod_step2", C_l[b])
            t.append_fr(b"gprod_step2", r_p)
            beta = t.get_and_append_challenge(b"gprod_beta")
            beta_inv = fr_inv(beta)

            u_raw = fr_powers_raw(beta_inv, ell + 1)
            u_raw = (u_raw[:32 * ell]
                     + u_raw[32 * ell: 32 * (ell + 1)] * N_BLINDERS)

            # vec_d[i] = f_i*beta^(i+1) - beta^i = beta^i * (beta*f_i - 1):
            # three native chains instead of 3*ell python bigint muls
            bf = fr_scale_raw(beta, factors_raw_l[b])
            bf_m1 = fr_axpy(R - 1, bf, ones_ell)               # beta*f - 1
            # [1, b, .., b^l-1]
            excl_pows = one32 + fr_powers_raw(beta, ell - 1)
            vec_d_raw = fr_mul_vec(bf_m1, excl_pows)
            beta_ell1 = fr_pow(beta, ell + 1)
            vec_d_blinders = [beta_ell1 * f % R for f in rbpa]
            D_pt = _msm3([B_l[b], crs.G_sum, crs.H_sum],
                         [1, (-beta_inv) % R, alpha])
            inner_prod = (r_p * beta_ell1
                          + gprod_l[b] * fr_pow(beta, ell) - 1) % R

            c_full_raw = vec_c_l[b] + ints_to_raw(d["c_blinders"])
            d_full_raw = vec_d_raw + ints_to_raw(vec_d_blinders)
            rc_raw = ints_to_raw(d["ipa_r"])
            z_raw = ints_to_raw(d["ipa_z"])
            # the 2x2 blinder solve (reference inner_product_argument.rs:42-82)
            # over native inner products
            omega = (fr_inner2(rc_raw, d_full_raw, n)[0]
                     + fr_inner2(z_raw, c_full_raw[: 32 * (n - 2)],
                                 n - 2)[0]) % R
            delta = fr_inner2(rc_raw[: 32 * (n - 2)], z_raw, n - 2)[0]
            c_nm2 = int.from_bytes(c_full_raw[32 * (n - 2): 32 * (n - 1)],
                                   "little")
            c_nm1 = int.from_bytes(c_full_raw[32 * (n - 1):], "little")
            r_nm2, r_nm1 = d["ipa_r"][n - 2], d["ipa_r"][n - 1]
            inv_c = fr_inv(c_nm2)
            denom = (-r_nm2 * inv_c % R * c_nm1 + r_nm1) % R
            last_z = ((r_nm2 * inv_c % R * omega - delta) % R
                      * fr_inv(denom) % R)
            penult_z = -inv_c * ((last_z * c_nm1 + omega) % R) % R
            rd_raw = (z_raw + penult_z.to_bytes(32, "little")
                      + last_z.to_bytes(32, "little"))
            ipa_state.append(dict(
                u=u_raw, D=D_pt, z=inner_prod, r_p=r_p,
                c=c_full_raw, d=d_full_raw, rc=rc_raw, rd=rd_raw))

        # ---- dispatch 3: IPA blinder commitments B_c, B_d -------------------
        rels = []
        for b in range(B):
            st = ipa_state[b]
            rels.append((acols, st["rc"]))
            rels.append((acols, fr_mul_vec(st["rd"], st["u"])))
        d3 = disp.run(rels)
        for b in range(B):
            st = ipa_state[b]
            st["B_c"], st["B_d"] = d3[2 * b], d3[2 * b + 1]
            t = ts[b]
            t.append_points(b"ipa_step1", [C_l[b], st["D"]])
            t.append_fr(b"ipa_step1", st["z"])
            t.append_points(b"ipa_step1", [st["B_c"], st["B_d"]])
            alpha = t.get_and_append_challenge(b"ipa_alpha")
            st["beta"] = t.get_and_append_challenge(b"ipa_beta")
            st["c"] = fr_axpy(alpha, st["rc"], st["c"])
            st["d"] = fr_axpy(alpha, st["rd"], st["d"])
            st["wC"] = st["wD"] = (1).to_bytes(32, "little")
            st["L"] = dict(L_C=[], L_D=[], R_C=[], R_D=[])

    # ---- IPA folding rounds: one grouped dispatch per round ---------------
    with span("prove.ipa_rounds"):
        h_col = np.array([H_idx], np.int32)
        for k in range(lg_n):
            posL, posR = rounds[k]
            half = (n >> k) // 2
            rels = []
            for b in range(B):
                st = ipa_state[b]
                c, d = st["c"], st["d"]
                c_L, c_R = c[: 32 * half], c[32 * half:]
                d_L, d_R = d[: 32 * half], d[32 * half:]
                ipL, ipR = fr_inner2(c_L + c_R, d_R + d_L, half)
                st["ips"] = (ipL, ipR)
                beta = st["beta"]
                u = st["u"]
                uL = _gather32(u, posL)
                uR = _gather32(u, posR)
                rels.append((np.concatenate([acols[posR], h_col]),
                             fr_outer(c_L, st["wC"])
                             + (beta * ipL % R).to_bytes(32, "little")))
                rels.append((acols[posL],
                             fr_mul_vec(fr_outer(d_R, st["wD"]), uL)))
                rels.append((np.concatenate([acols[posL], h_col]),
                             fr_outer(c_R, st["wC"])
                             + (beta * ipR % R).to_bytes(32, "little")))
                rels.append((acols[posR],
                             fr_mul_vec(fr_outer(d_L, st["wD"]), uR)))
            pts = disp.run(rels)
            for b in range(B):
                st = ipa_state[b]
                L_C, L_D, R_C, R_D = pts[4 * b: 4 * b + 4]
                st["L"]["L_C"].append(L_C)
                st["L"]["L_D"].append(L_D)
                st["L"]["R_C"].append(R_C)
                st["L"]["R_D"].append(R_D)
                t = ts[b]
                t.append_points(b"ipa_loop", [L_C, L_D, R_C, R_D])
                gamma = t.get_and_append_challenge(b"ipa_gamma")
                gamma_inv = fr_inv(gamma)
                c, d = st["c"], st["d"]
                st["c"] = fr_axpy(gamma_inv, c[: 32 * half], c[32 * half:])
                st["d"] = fr_axpy(gamma, d[: 32 * half], d[32 * half:])
                st["wC"] = _interleave(st["wC"], fr_scale_raw(gamma, st["wC"]))
                st["wD"] = _interleave(st["wD"],
                                       fr_scale_raw(gamma_inv, st["wD"]))

        ipa_proofs = []
        for b in range(B):
            st = ipa_state[b]
            L = st["L"]
            ipa_proofs.append(InnerProductProof(
                st["B_c"], st["B_d"], L["L_C"], L["R_C"], L["L_D"], L["R_D"],
                int.from_bytes(st["c"], "little"),
                int.from_bytes(st["d"], "little")))

    # ---- step 3: same-scalar sigma protocol (host GLV batch) --------------
    with span("prove.same_scalar"):
        jobs = []
        for b in range(B):
            d = dr[b]
            k_s = insts[b].k
            # order: [k*Rhat, k*Shat, r_k*Rhat, r_k*Shat,
            #         r_t*G_t, r_u*G_u, r_a*G_t, r_b*G_u,
            #         r_t*H, r_u*H, r_a*H, r_b*H]
            jobs.extend([(Rhat[b], k_s), (Shat[b], k_s),
                         (Rhat[b], d["r_k"]), (Shat[b], d["r_k"]),
                         (crs.G_t, d["r_t"]), (crs.G_u, d["r_u"]),
                         (crs.G_t, d["r_a"]), (crs.G_u, d["r_b"]),
                         (crs.H, d["r_t"]), (crs.H, d["r_u"]),
                         (crs.H, d["r_a"]), (crs.H, d["r_b"])])
        muls = _batch_mul_each([p for p, _ in jobs], [s for _, s in jobs])

        samescalar_l, cm_T_l, cm_U_l = [], [], []
        for b in range(B):
            m = muls[12 * b: 12 * b + 12]
            cm_T = GroupCommitment(m[4], m[0].add(m[8]))
            cm_U = GroupCommitment(m[5], m[1].add(m[9]))
            cm_A = GroupCommitment(m[6], m[2].add(m[10]))
            cm_B = GroupCommitment(m[7], m[3].add(m[11]))
            t, d = ts[b], dr[b]
            t.append_points(b"sameexp_points", [
                Rhat[b], Shat[b], cm_T.T_1, cm_T.T_2, cm_U.T_1, cm_U.T_2,
                cm_A.T_1, cm_A.T_2, cm_B.T_1, cm_B.T_2])
            alpha = t.get_and_append_challenge(b"same_scalar_alpha")
            samescalar_l.append(SameScalarProof(
                cm_A, cm_B,
                (d["r_k"] + insts[b].k * alpha) % R,
                (d["r_a"] + d["r_t"] * alpha) % R,
                (d["r_b"] + d["r_u"] * alpha) % R))
            cm_T_l.append(cm_T)
            cm_U_l.append(cm_U)

    # ---- step 4: same-multiscalar argument ---------------------------------
    with span("prove.msm_rounds"):
        rels = []
        for b in range(B):
            r_raw = ints_to_raw(dr[b]["msm_r"])
            rels.append((gcols, r_raw))
            rels.append((tcols[b], r_raw))
            rels.append((ucols[b], r_raw))
        d4 = disp.run(rels)

        from ..host.serde import g1_to_bytes, vec_len_prefix

        inf_b = g1_to_bytes(G1.infinity())
        h_b = g1_to_bytes(crs.H)
        sm_state = []
        for b in range(B):
            t, d = ts[b], dr[b]
            A_prime = A_l[b].add(cm_T_l[b].T_1).add(cm_U_l[b].T_1)
            B_a, B_t, B_u = d4[3 * b: 3 * b + 3]
            # T/U-with-blinders payloads from the step-1 joined bodies (strip
            # the u64 length prefix, append the 4 fixed blinder columns) — the
            # byte stream is identical to append_point_vec on the built lists
            body_T, body_U = tu_bodies[b]
            t.append_points(b"same_msm_step1",
                            [A_prime, cm_T_l[b].T_2, cm_U_l[b].T_2])
            t.append_message(b"same_msm_step1", vec_len_prefix(n) + body_T
                             + inf_b + inf_b + h_b + inf_b)
            t.append_message(b"same_msm_step1", vec_len_prefix(n) + body_U
                             + inf_b + inf_b + inf_b + h_b)
            t.append_points(b"same_msm_step1", [B_a, B_t, B_u])
            alpha = t.get_and_append_challenge(b"same_msm_alpha")
            vec_x = a_perm_l[b] + d["a_blinders"] + [d["r_t"], d["r_u"]]
            x = fr_axpy(alpha, ints_to_raw(d["msm_r"]), ints_to_raw(vec_x))
            sm_state.append(dict(
                x=x, w=(1).to_bytes(32, "little"), B=(B_a, B_t, B_u),
                L=dict(L_A=[], L_T=[], L_U=[], R_A=[], R_T=[], R_U=[])))

        for k in range(lg_n):
            posL, posR = rounds[k]
            half = (n >> k) // 2
            rels = []
            for b in range(B):
                st = sm_state[b]
                x = st["x"]
                sL = fr_outer(x[: 32 * half], st["w"])
                sR = fr_outer(x[32 * half:], st["w"])
                rels.append((gcols[posR], sL))
                rels.append((tcols[b][posR], sL))
                rels.append((ucols[b][posR], sL))
                rels.append((gcols[posL], sR))
                rels.append((tcols[b][posL], sR))
                rels.append((ucols[b][posL], sR))
            pts = disp.run(rels)
            for b in range(B):
                st = sm_state[b]
                L_A, L_T, L_U, R_A, R_T, R_U = pts[6 * b: 6 * b + 6]
                for key, p in zip(("L_A", "L_T", "L_U", "R_A", "R_T", "R_U"),
                                  (L_A, L_T, L_U, R_A, R_T, R_U)):
                    st["L"][key].append(p)
                t = ts[b]
                t.append_points(b"same_msm_loop",
                                [L_A, L_T, L_U, R_A, R_T, R_U])
                gamma = t.get_and_append_challenge(b"same_msm_gamma")
                x = st["x"]
                st["x"] = fr_axpy(fr_inv(gamma), x[: 32 * half], x[32 * half:])
                st["w"] = _interleave(st["w"], fr_scale_raw(gamma, st["w"]))

    # ---- assemble -----------------------------------------------------------
    with span("prove.assemble"):
        proofs = []
        for b in range(B):
            st = sm_state[b]
            L = st["L"]
            same_msm = SameMultiscalarProof(
                *st["B"], L["L_A"], L["L_T"], L["L_U"],
                L["R_A"], L["R_T"], L["R_U"],
                int.from_bytes(st["x"], "little"))
            gp = GrandProductProof(C_l[b], _rp_of(ipa_state[b]), ipa_proofs[b])
            proofs.append(CurdleproofsProof(
                A_l[b], cm_T_l[b], cm_U_l[b], Rhat[b], Shat[b],
                SamePermutationProof(B_l[b], gp), samescalar_l[b], same_msm))
    return proofs


def _rp_of(st: dict) -> int:
    return st["r_p"]


def _gather32(buf: bytes, pos: np.ndarray) -> bytes:
    """Gather 32-byte rows of `buf` at `pos`."""
    a = np.frombuffer(buf, np.uint8).reshape(-1, 32)
    return a[pos].tobytes()


def _msm3(points: list[G1], scalars: list[int]) -> G1:
    """Tiny eager host MSM (2-3 terms: the CRS-sums tricks)."""
    nat = _native()
    if nat is not None:
        return nat.msm(points, scalars)
    acc = G1.infinity()
    for p, s in zip(points, scalars):
        acc = acc.add(p.mul(s))
    return acc


def _batch_mul_each(points: list[G1], scalars: list[int]) -> list[G1]:
    nat = _native()
    if nat is not None:
        return nat.batch_mul_each_glv(points, scalars)
    return [p.mul(s) for p, s in zip(points, scalars)]
