"""Entry: `curdleproofs_tpu_torch.parallel.batch_prove.batch_prove`.

A service proves many independent shuffles at once and pays in proofs a
second: each call is one wave of instances, `instances_per_wave` of them
or, where the mix gives `wave_positions` instead, that many over n.

Inputs (the reference's process, from the seed, by `cpref`): the
configuration's CRS; per instance, from its own sub-seed, its random
(R, S) of `ell` points each (random scalars times the generator), its
permutation, k and blinders, (T, U, M) from them, and the seed of its
prover RNG.  Every wave gets the inputs anew in the program's types, as
a caller would hand them over (fresh point objects, with no encoding
cached on them, and a fresh RNG an instance at that seed), so each wave
does the work that new inputs would.

The comparison: the proofs of a sample of instances (one from each
quarter of the wave, drawn from the seed), in every wave of the window,
byte for byte against the reference's sequential prover on the same
inputs and RNG seeds.  Every grouped-MSM point enters its proof's bytes,
so the bytes cover the points.
"""

from __future__ import annotations

import random

from harness.convert import program_crs, reference_crs_affine
from harness.probes import install_fold_probe, span_method, sub_seed

# the span of a call; the dispatches inside it are spans too, so the
# trace's idle gaps inside a wave but outside a dispatch are the witness
# host code
CALL_SPAN = "wave"


def wave_size(cfg: dict, params: dict) -> int:
    if "instances_per_wave" in params:
        return params["instances_per_wave"]
    return params["wave_positions"] // (cfg["ell"] + cfg["n_blinders"])


def sample_of(seed: int, B: int) -> list[int]:
    """One instance from each quarter of the wave, drawn from the seed."""
    if B < 4:
        raise ValueError(f"a wave of {B} instances: too few to sample")
    pick = random.Random(sub_seed(seed, "sample"))
    q = B // 4
    return [j * q + pick.randrange(q) for j in range(4)]


# --- the reference's side (its own process) ---------------------------------

_REF = {}   # the CRS, for the forked workers


def _ref_instance(crs, seed: int, i: int):
    """One instance from its sub-seed: (R, S, T, U, M, perm, k, blinders,
    prover seed) in the reference's types."""
    from cpref.constants import N_BLINDERS, R
    from cpref.host.g1 import GENERATOR
    from cpref.host.rng import StdRng
    from cpref.util import generate_blinders, get_permutation, msm
    from cpref.backend import get_backend

    ell = len(crs.vec_G)
    rng = StdRng.seed_from_u64(sub_seed(seed, f"instance:{i}"))
    r = [rng.rand_fr() for _ in range(ell)]
    s = [rng.rand_fr() for _ in range(ell)]
    perm = list(range(ell))
    rng.shuffle(perm)
    k = rng.rand_fr()
    blinders = generate_blinders(rng, N_BLINDERS)
    be = get_backend()
    gens = [GENERATOR] * ell
    vec_r, vec_s = be.batch_mul_each(gens, r), be.batch_mul_each(gens, s)
    vec_t = be.batch_mul_each(gens, get_permutation([k * x % R for x in r], perm))
    vec_u = be.batch_mul_each(gens, get_permutation([k * x % R for x in s], perm))
    m = msm(crs.vec_G, get_permutation(list(range(ell)), perm)) \
        .add(msm(crs.vec_H, blinders))
    return (vec_r, vec_s, vec_t, vec_u, m, perm, k, blinders,
            sub_seed(seed, f"prover:{i}"))


def _flat_instance(args):
    from cpref.host.g1 import G1

    inst = _ref_instance(_REF["crs"], *args)
    flat = [[c for xy in G1.batch_to_affine(v) for c in xy] for v in inst[:4]]
    return (*flat, inst[4].to_affine(), *inst[5:])


def make_inputs(rctx):
    from cpref.crs import CurdleproofsCrs

    B = wave_size(rctx.cfg, rctx.params)
    sample = sample_of(rctx.seed, B)
    _REF["crs"] = crs = CurdleproofsCrs.generate_crs(rctx.cfg["ell"])
    flat = rctx.map(_flat_instance, [(rctx.seed, i) for i in range(B)])
    data = {"crs": reference_crs_affine(crs), "instances": flat}
    return data, {"crs": crs, "sample": sample, "B": B}


def _ref_proof(crs, seed: int, i: int, backend=None):
    from cpref.backend import HostBackend, use_backend
    from cpref.curdleproofs import CurdleproofsProof
    from cpref.host.rng import StdRng

    R_, S, T, U, M, perm, k, blinders, pseed = _ref_instance(crs, seed, i)
    with use_backend(backend or HostBackend()):
        return CurdleproofsProof.new(crs, R_, S, T, U, M, perm, k, blinders,
                                     StdRng.seed_from_u64(pseed)).serialize()


def judge(rctx, ref, outputs) -> dict:
    """The sampled proofs of every wave against the reference's bytes; a
    proof missing from a wave counts as differing."""
    want = {i: _ref_proof(ref["crs"], rctx.seed, i) for i in ref["sample"]}
    bad = sum(out["sample"].get(i) != want[i]
              for out in outputs["waves"] for i in ref["sample"])
    short = sum(out["count"] != ref["B"] for out in outputs["waves"])
    return {"proof_mismatches": (bad, 0), "short_waves": (short, 0)}


# --- the program's side (the timed process) ----------------------------------

class State:
    pass


def units(st, kind: str) -> int:
    return st.B


def setup(ctx, data) -> State:
    st = State()
    st.ctx = ctx
    st.B = wave_size(ctx.cfg, ctx.params)
    st.sample = sample_of(ctx.seed, st.B)
    # what each wave's objects are made from: flat affine coordinates and
    # plain ints
    st.inputs = data["instances"]
    st.crs = program_crs(data["crs"])
    st.half = False
    if ctx.device != "cuda":
        from curdleproofs_tpu_torch.backend import set_backend
        from curdleproofs_tpu_torch.ops.backend import TorchBackend

        set_backend(TorchBackend(device=ctx.device))
    ctx.counters["last_timings"] = []
    return st


def instrument(st) -> None:
    """The grouped MSM's dispatches as spans; in a traced run the fold's
    least work."""
    from curdleproofs_tpu_torch.parallel import batch_prove as bp

    span_method(bp._Dispatcher, "run", st.ctx.spans, "dispatch")
    install_fold_probe(st.ctx)


def _instances(st, count: int):
    from curdleproofs_tpu_torch.host.g1 import G1
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.parallel.batch_prove import ProveInstance

    def points(flat):
        return [G1(flat[j], flat[j + 1], 1) for j in range(0, len(flat), 2)]

    return [ProveInstance(points(r), points(s), points(t), points(u),
                          G1(m[0], m[1], 1), list(perm), k, list(blinders),
                          StdRng.seed_from_u64(seed))
            for r, s, t, u, m, perm, k, blinders, seed in st.inputs[:count]]


def run(st, kind: str) -> dict:
    from curdleproofs_tpu_torch.parallel import batch_prove as bp

    insts = _instances(st, st.B // 2 if st.half else st.B)
    proofs = bp.batch_prove(st.crs, insts)
    if st.ctx.spans.enabled:
        st.ctx.counters["last_timings"].append(dict(bp.batch_prove.last_timings))
    return {"count": len(proofs),
            "sample": {i: proofs[i] for i in st.sample if i < len(proofs)}}


def _half_width_backend():
    """The reference's host engine with every MSM's scalars cut to their
    low 128 bits, the scalar field's "lower precision"."""
    from cpref.backend import HostBackend

    class HalfWidth(HostBackend):
        name = "half-width"
        MASK = (1 << 128) - 1

        def msm(self, points, scalars):
            return super().msm(points, [s & self.MASK for s in scalars])

    return HalfWidth()


def run_control(st, kind: str) -> dict:
    """The reference in the program's place with one guarantee broken:
    the sequential prover with its MSMs on half-width scalars.  Only the
    sampled instances are proved (only they are judged)."""
    from cpref.crs import CurdleproofsCrs

    if not hasattr(st, "ref_crs"):
        st.ref_crs = CurdleproofsCrs.generate_crs(st.ctx.cfg["ell"])
    sample = {i: _ref_proof(st.ref_crs, st.ctx.seed, i, _half_width_backend())
              for i in st.sample}
    return {"count": st.B, "sample": sample}


def _answer_altered(call):
    def altered(st, kind):
        out = call(st, kind)
        i = st.sample[-1]
        if i in out["sample"]:
            got = out["sample"][i]
            bad = bytearray(got if isinstance(got, bytes) else got.serialize())
            bad[len(bad) // 2] ^= 1
            out["sample"][i] = bytes(bad)
        return out
    return altered


def _half_batch(call):
    def half(st, kind):
        st.half = True
        return call(st, kind)
    return half


FAULTS = {"answer_altered": _answer_altered, "half_batch": _half_batch}


def report(st) -> list[str]:
    lt = st.ctx.counters.get("last_timings", [])
    return [f"wave {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
            for i, t in enumerate(lt[:3])]


def release(st) -> None:
    st.crs = None
    st.inputs = None


def outputs(st, done) -> dict:
    """The sampled proofs' bytes of every wave, for the reference."""
    return {"waves": [
        {"count": out["count"],
         "sample": {i: p if isinstance(p, bytes) else p.serialize()
                    for i, p in out["sample"].items()}}
        for _, out in done]}
