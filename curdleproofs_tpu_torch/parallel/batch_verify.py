"""Batched shuffle-proof verification (the JAX package's
`parallel/batch_verify.py`).

All proofs in a batch share ONE MSM accumulator: each proof's deferred checks
enter the random linear combination, and the CRS bases (identical across
proofs) dedup, so B proofs cost B x (transcript replay + small muls) on the
host plus a SINGLE giant MSM, which the active backend runs (on the card
under `TorchBackend`), or, given a `mesh`, the sharded MSM over that grid
of devices (`parallel/sharded_msm.py`).  With `stream_chunk`, that MSM is
split between a `DeviceMsmStream` on the card and the host, chunk by chunk,
as the replays go.

Semantics: all-or-nothing (a single invalid proof fails the batch);
`identify=True` bisects to per-proof verdicts on failure.  Only
`VerificationError` means "invalid": a device fault is raised, never
turned into a False verdict.
"""

from __future__ import annotations

import time

from ..crs import CurdleproofsCrs
from ..curdleproofs import CurdleproofsProof
from ..errors import VerificationError
from ..host.rng import StdRng
from ..msm_accumulator import MsmAccumulator
from ..ops.backend import active_device
from ..utils.trace import span

__all__ = ["batch_verify", "ShuffleInstance", "plan_split_fraction"]


class ShuffleInstance:
    """One shuffle statement: (R, S) -> (T, U) with permutation commitment M."""

    __slots__ = ("vec_R", "vec_S", "vec_T", "vec_U", "M")

    def __init__(self, vec_R, vec_S, vec_T, vec_U, M):
        self.vec_R = vec_R
        self.vec_S = vec_S
        self.vec_T = vec_T
        self.vec_U = vec_U
        self.M = M


def plan_split_fraction(replay_s_per_chunk: float = 0.0,
                        bases_per_chunk: int | None = None,
                        worker: bool = False, device="cuda") -> float:
    """Fraction of the batch's MSM terms the device should take.

    Timeline model on a 1-core host.  Per device chunk the host blocks only
    on the prep's host share `p` (native export + array staging; the upload
    and sqrt ingest drain on the device, tabled as `fresh_prep_host_ms` vs
    `fresh_prep_ms`); the device is busy `d = (prep_total - prep_host) +
    device_warm` per chunk.  Host chunks cost the host `h = host_ms` of
    final-MSM work.  Host timeline = replays + f*C*p + (1-f)*C*h; device
    busy = f*C*d.  Since p < h on every tuned platform, the total falls as f
    rises until the device becomes the tail; the optimum is the equality
        f = (r + h) / (d + h - p)
    with r the replay wall per chunk (pass the live measurement; r = 0 is
    the conservative default).  Every term scales with the same chunk size,
    so only r needs the caller's units: seconds per chunk of
    `bases_per_chunk` terms.  The table is the one for `device`'s type
    (ops/msm_tune.py); untuned, the split is 50/50."""
    from ..ops.msm_device import stream_params
    from ..ops.msm_tune import load_table

    n_fam = stream_params(device=device).n
    entry = load_table(device).get(n_fam)
    if entry is None:
        return 0.5
    scale = (bases_per_chunk / n_fam) if bases_per_chunk else 1.0
    h = entry["host_ms"] * scale
    # Known simplification, kept from the reference: with the async-worker
    # stream the chunk prep runs on a thread, so its host share is taken as
    # 0.  That thread still competes with the replays for the host's cores
    # and for the interpreter lock between native calls, so the model
    # overstates the device's share where host prep is not negligible.
    p_host = (0.0 if worker else
              entry.get("fresh_prep_host_ms", entry["fresh_prep_ms"]) * scale)
    # device busy per chunk: the steady-state feed (upload + ingest,
    # "ingest_dev_ms") + the pipeline wall; tables without it fall back to
    # the single-shot prep estimate
    ingest = entry.get(
        "ingest_dev_ms",
        entry["fresh_prep_ms"] - entry.get("fresh_prep_host_ms", 0.0))
    d = (ingest + entry["device_warm_ms"]) * scale
    r = replay_s_per_chunk * 1e3
    if p_host >= h:
        # a device chunk blocks the host longer than just MSM-ing it would:
        # the device cannot help at any fraction
        return 0.0
    if h <= 0 or d + h - p_host <= 0:
        return 0.5
    return max(0.0, min(1.0, (r + h) / (d + h - p_host)))


def _batch_verify_streamed(
    crs: CurdleproofsCrs,
    instances: list[ShuffleInstance],
    proofs: list[CurdleproofsProof],
    rng: StdRng,
    chunk: int,
    mark=None,
) -> bool:
    """Replay chunks of proofs, SPLITTING the final MSM between the device
    stream and the host engine by the cost model.

    A `plan_split_fraction()` share of replay chunks dedups into the device
    stream (dispatched on its worker thread, crunched while the remaining
    replays run); the rest accumulate into one host accumulator whose single
    deduped MSM runs after the replays.  Partial MSMs sum because the
    accumulator's checks are one random linear combination: device share +
    host share must be the identity.  Chunk 0 always goes to the idle
    device; its replay wall and dedup size calibrate the split.  The stream
    dispatches a power-of-two family in [2^9, 2^16], sized from chunk 0.

    `_batch_verify_streamed.last_split` records the split and `last_stats`
    the stream's dispatch count, the terms each engine took and the replay
    wall."""
    from ..backend import HostBackend
    from ..ops.msm_device import STREAM_LOGN, DeviceMsmStream

    device = active_device()
    n_chunks = -(-len(proofs) // chunk)
    stream: DeviceMsmStream | None = None
    host_acc = MsmAccumulator()
    f_dev = 1.0
    credit = 1.0
    device_terms = 0
    replay_total = 0.0
    try:
        for off in range(0, len(proofs), chunk):
            to_device = credit >= 1.0
            if to_device:
                credit -= 1.0
                acc = MsmAccumulator()
            else:
                acc = host_acc
            t0 = time.perf_counter()
            for i in range(off, min(off + chunk, len(proofs))):
                _replay(crs, instances[i], proofs[i], acc, rng)
            replay_s = time.perf_counter() - t0
            replay_total += replay_s
            if to_device:
                bases, scalars = acc.dedup_raw()
                device_terms += len(bases)
                if stream is None:
                    f_dev = plan_split_fraction(replay_s, len(bases),
                                                worker=True, device=device)
                    est = max(1, len(bases)) * n_chunks
                    logn = min(STREAM_LOGN, max(9, (est - 1).bit_length()))
                    stream = DeviceMsmStream(1 << logn, async_worker=True,
                                             device=device, mark=mark)
                stream.add(bases, scalars)
            credit += f_dev
    except VerificationError:
        if stream is not None:
            stream.result()  # join the worker; a device fault still raises
        return False

    # host share first, on the host engine: its MSM runs while the device
    # drains its queue
    bases, scalars = host_acc.dedup_raw()
    host_part = None
    if bases:
        if isinstance(scalars, (bytes, bytearray)):
            host_part = HostBackend().msm_raw(bases, scalars)
        else:
            host_part = HostBackend().msm(bases, scalars)
    total = stream.result() if stream is not None else None
    _batch_verify_streamed.last_split = f_dev
    _batch_verify_streamed.last_stats = {
        "chunks": n_chunks,
        "dispatches": stream.dispatches if stream is not None else 0,
        "stream_n": stream.params.n if stream is not None else 0,
        "device_terms": device_terms, "host_terms": len(bases),
        "replay_s": replay_total}
    if total is None:
        total = host_part
    elif host_part is not None:
        total = total.add(host_part)
    return total is not None and total.is_infinity()


def _replay(crs, inst: ShuffleInstance, proof: CurdleproofsProof,
            acc: MsmAccumulator, rng: StdRng) -> None:
    """One proof's transcript replay into the batch's accumulator."""
    with span("verify.replay", timeline=False):
        proof.verify_with_accumulator(crs, inst.vec_R, inst.vec_S,
                                      inst.vec_T, inst.vec_U, inst.M, acc,
                                      rng)


def _final_check(acc: MsmAccumulator, mesh=None) -> bool:
    with span("verify.final_check"):
        if mesh is None:
            try:
                acc.verify()
                return True
            except VerificationError:
                return False
        from .sharded_msm import sharded_msm

        bases, scalars = acc._dedup()
        return sharded_msm(bases, scalars, mesh).is_infinity()


def batch_verify(
    crs: CurdleproofsCrs,
    instances: list[ShuffleInstance],
    proofs: list[CurdleproofsProof],
    rng: StdRng,
    mesh=None,
    identify: bool = False,
    stream_chunk: int | None = None,
    mark=None,
) -> bool | list[bool]:
    """Verify many proofs with one deduped MSM, sharded over `mesh` (a
    `sharded_msm.MsmMesh`) when one is given.

    `stream_chunk=B_c` pipelines the final MSM with the replays: every B_c
    proofs, the chunk's deduped terms go to the device stream or to the
    host accumulator (`_batch_verify_streamed`), so the device crunches
    chunk k while the host replays chunk k+1.  Chunk dedup merges the CRS
    bases within a chunk; the shared bases repeat once per chunk across
    chunks, negligible against the per-proof fresh bases.  `mark` reaches
    the stream (`DeviceMsmStream`).

    Returns a bool, or per-proof verdicts when `identify=True` and the batch
    fails (log-depth bisection; valid batches still cost one MSM).
    """
    if len(instances) != len(proofs):
        raise ValueError("one instance per proof")

    if stream_chunk is not None and not identify and len(proofs) > 0:
        return _batch_verify_streamed(crs, instances, proofs, rng,
                                      stream_chunk, mark)

    def run(idx: list[int]) -> bool:
        acc = MsmAccumulator()
        try:
            for i in idx:
                _replay(crs, instances[i], proofs[i], acc, rng)
        except VerificationError:
            # an eagerly-checked sub-argument (same-scalar) already failed;
            # for batch semantics that fails the whole subset
            return False
        return _final_check(acc, mesh)

    all_idx = list(range(len(proofs)))
    ok = run(all_idx)
    if ok or not identify:
        return ok

    # bisect to find the offenders
    verdicts = [True] * len(proofs)

    def bisect(idx: list[int]) -> None:
        if len(idx) == 1:
            verdicts[idx[0]] = run(idx)
            return
        mid = len(idx) // 2
        for part in (idx[:mid], idx[mid:]):
            if not run(part):
                bisect(part)

    bisect(all_idx)
    return verdicts
