"""Deferred-MSM verifier accumulator (parity: `curdleproofs/src/msm_accumulator.rs`).

Collapses every check `C == <x, V>` into one random linear combination, dedup'ing
repeated bases, then verifies them all with ONE giant MSM — the verifier's single
hot kernel, and the MSM the device backend runs on the card.
"""

from __future__ import annotations

from .constants import R
from .errors import VerificationError
from .host.g1 import G1
from .host.rng import StdRng
from .util import FrVec, msm
from .utils.trace import span

# Below this many accumulated scalar terms the python dict merge wins on
# latency; above it the fused native sweep (cp_fr_scale_accum) wins.
_NATIVE_DEDUP_MIN = 768

__all__ = ["MsmAccumulator"]


class MsmAccumulator:
    def __init__(self):
        # raw relations (random_factor, vec_x, vec_V); the random scaling AND
        # the dedup both happen ONCE at verify time (arkworks dedups eagerly
        # per check on a G1Affine hash map, msm_accumulator.rs:37-52 — same
        # semantics, but accumulation stays allocation-only on the
        # batch-verification replay hot path)
        self._rels: list[tuple[int, list[int], list[G1]]] = []

    def accumulate_zero(self, vec_x: list[int], vec_V: list[G1],
                        rng: StdRng) -> None:
        """Accumulate the relation `<vec_x, vec_V> == 0` under a fresh random
        factor. No group OR scalar math happens here — the whole batch of
        relations is verified by the single MSM `sum_i rf_i * <x_i, V_i> == 0`."""
        self._rels.append((rng.rand_fr(), vec_x, vec_V))

    def accumulate_check(self, C: G1, vec_x: list[int], vec_V: list[G1],
                         rng: StdRng) -> None:
        """Accumulate the check `C == <vec_x, vec_V>` (zero-relation form:
        C enters the base set with weight -1)."""
        self.accumulate_zero(vec_x + [-1 % R], vec_V + [C], rng)

    def _dedup(self) -> tuple[list[G1], list[int]]:
        """Merge scalars of repeated bases, keyed on OBJECT identity.

        The duplicates that matter (CRS vectors, instance points accumulated
        by several sub-arguments) are always the same python objects, so id()
        catches them without normalising every point to affine first — at
        1024-proof batches the batch_to_affine keying this replaces cost
        ~12 us/point across >10^6 points, dwarfing the MSM itself.  Distinct
        objects holding equal points simply stay separate MSM terms, which is
        valid (duplicate bases are legal MSM inputs) and costs one extra
        bucket add each; arkworks' value-keyed map (msm_accumulator.rs:37-52)
        merges those too, but no protocol path produces them.
        """
        from .host import native

        nat = native if native.available() else None
        if nat is not None and sum(len(xs) for _, xs, _ in self._rels) >= _NATIVE_DEDUP_MIN:
            return self._dedup_native(nat)
        scal: dict[int, int] = {}
        pt: dict[int, G1] = {}
        for rf, xs, Vs in self._rels:
            if isinstance(xs, FrVec):
                xs = xs.to_ints()
            # the random scaling runs as one native Montgomery-mul sweep;
            # the merge then only adds (mod deferred to extraction)
            if nat is not None and len(xs) >= 32:
                xs = nat.fr_scale(rf, xs)
            else:
                xs = [rf * x % R for x in xs]
            for base, x in zip(Vs, xs):
                key = id(base)
                cur = scal.get(key)
                if cur is None:
                    scal[key] = x
                    pt[key] = base
                else:
                    scal[key] = cur + x
        return list(pt.values()), [scal[k] % R for k in pt]

    def _dedup_native(self, nat, raw: bool = False):
        """Big-batch dedup: python only maps base objects to dense indices
        (memoised per base-LIST object — the CRS vectors recur across every
        proof of a batch); the scalar work `acc[key] += rf * x mod r` runs
        as one fused native sweep per relation (cp_fr_scale_accum).  The
        base lists captured in `_rels` must not be mutated before verify —
        the protocol code never does (they are CRS/instance/proof vectors)."""
        from array import array

        idx_of: dict[int, int] = {}
        pts: list[G1] = []
        key_memo: dict[int, array] = {}
        jobs = []
        for rf, xs, Vs in self._rels:
            keys = key_memo.get(id(Vs))
            if keys is None:
                keys = array("I", bytes(4 * len(Vs)))
                for t, base in enumerate(Vs):
                    k = idx_of.get(id(base))
                    if k is None:
                        k = len(pts)
                        idx_of[id(base)] = k
                        pts.append(base)
                    keys[t] = k
                key_memo[id(Vs)] = keys
            jobs.append((rf, xs.to_raw() if isinstance(xs, FrVec) else xs,
                         keys))
        return pts, nat.fr_scale_accum(jobs, len(pts), raw=raw)

    def dedup_raw(self):
        """(bases, scalars) with scalars as raw canonical 32 B-LE bytes when
        the native runtime produces them (the fused-dedup fast path), python
        ints otherwise.  `Backend.msm_raw` and `DeviceMsmStream.add` accept
        both forms."""
        from .host import native

        with span("msm.dedup"):
            if (native.available() and sum(len(xs) for _, xs, _ in self._rels)
                    >= _NATIVE_DEDUP_MIN):
                return self._dedup_native(native, raw=True)
            return self._dedup()

    def verify(self) -> None:
        """Run the single deduped MSM; raise VerificationError on mismatch.

        With the native runtime, the merged scalars stay as raw canonical
        bytes from the dedup sweep through the GLV split into the MSM — no
        per-base python-int materialisation (backend.msm_raw)."""
        from .backend import get_backend

        bases, scalars = self.dedup_raw()
        if isinstance(scalars, (bytes, bytearray)):
            ok = get_backend().msm_raw(bases, scalars).is_infinity()
        else:
            ok = msm(bases, scalars).is_infinity()
        if not ok:
            raise VerificationError("accumulated MSM check failed")
