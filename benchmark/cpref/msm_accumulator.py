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
        scal: dict[int, int] = {}
        pt: dict[int, G1] = {}
        for rf, xs, Vs in self._rels:
            if isinstance(xs, FrVec):
                xs = xs.to_ints()
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

    def final_point(self) -> G1:
        """The single deduped MSM: the point that must be the identity."""
        bases, scalars = self._dedup()
        return msm(bases, scalars)

    def verify(self) -> None:
        """Run the single deduped MSM; raise VerificationError on mismatch."""
        if not self.final_point().is_infinity():
            raise VerificationError("accumulated MSM check failed")
