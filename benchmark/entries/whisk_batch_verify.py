"""Entry: `curdleproofs_tpu_torch.whisk.is_valid_whisk_shuffle_proofs`.

A syncing consensus node verifies a downloaded range of Whisk blocks in
one call: the protocol layer replays every proof on the host and one
deduped MSM on the card decides the batch.  Bytes in, default arguments.

Inputs (the reference's process, from the seed, by `cpref`): the
configuration's CRS; `blocks_per_batch` blocks, each from its own
sub-seed, with `ell` fresh random pre-trackers and its own shuffle
proof.  Kinds of work: `valid`, the batch as made; `tampered_early` and
`tampered_late`, the same batch with the low bit of the last scalar of
one proof flipped (a block of the first half, a block of the second),
which only the final MSM catches.  Each call gets fresh program RNG for
the random linear combination, from the seed and the call's number.

The comparison, in the reference's process: one call of each kind, drawn
from the seed, is replayed by the reference from the bytes with that
call's RNG; its verdict is the kind's, against which every call's
verdict is held, and the point its own deduped final MSM gives is held
against the point the program's final MSM returned in that call.
"""

from __future__ import annotations

import random

from harness.convert import program_crs, reference_crs_affine
from harness.probes import (install_fold_probe, point_affine, span_method,
                            sub_seed)

# the span of a call; inside it the harness also names the calls into
# the protocol layer that the batch makes, so the trace's idle gaps read
# by what the host was doing
CALL_SPAN = "batch"

# the order of BLS12-381's prime-order subgroup (the scalar field)
R = 0x73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001


def _tampered_blocks(seed: int, blocks: int) -> dict:
    pick = random.Random(sub_seed(seed, "tamper"))
    half = blocks // 2
    return {"tampered_early": pick.randrange(half),
            "tampered_late": half + pick.randrange(blocks - half)}


def _tamper(proof: bytes) -> bytes:
    """Flip the low bit of the proof's last scalar (32 bytes, LE),
    keeping it canonical."""
    for bit in range(8):
        bad = bytearray(proof)
        bad[-32] ^= 1 << bit
        if int.from_bytes(bad[-32:], "little") < R:
            return bytes(bad)
    raise ValueError("no canonical flip of the last scalar")


def _batches(blocks, bad: dict) -> dict:
    """The blocks of each kind of call: the tampered kinds share all but
    one block with the valid batch."""
    out = {"valid": list(blocks)}
    for kind, i in bad.items():
        pre, post, proof = blocks[i]
        out[kind] = list(blocks)
        out[kind][i] = (pre, post, _tamper(proof))
    return out


# --- the reference's side (its own process) ---------------------------------

_REF = {}   # the CRS, for the forked workers


def _ref_block(args):
    """One block from its sub-seed: the pre- and post-trackers as byte
    pairs, and the shuffle proof's bytes."""
    from cpref.host.rng import StdRng
    from cpref.whisk import WhiskTracker, generate_whisk_shuffle_proof

    seed, i = args
    rng = StdRng.seed_from_u64(sub_seed(seed, f"block:{i}"))
    pre = [WhiskTracker.from_rand(rng) for _ in range(len(_REF["crs"].vec_G))]
    post, proof = generate_whisk_shuffle_proof(rng, _REF["crs"], pre)
    return ([(t.r_G, t.k_r_G) for t in pre], [(t.r_G, t.k_r_G) for t in post],
            proof)


def make_inputs(rctx):
    from cpref.crs import CurdleproofsCrs

    _REF["crs"] = crs = CurdleproofsCrs.generate_crs(rctx.cfg["ell"])
    n = rctx.params["blocks_per_batch"]
    blocks = rctx.map(_ref_block, [(rctx.seed, i) for i in range(n)])
    data = {"crs": reference_crs_affine(crs), "blocks": blocks}
    return data, {"crs": crs, "blocks": blocks}


def _ref_trackers(pairs):
    from cpref.whisk import WhiskTracker

    return [WhiskTracker(r, k) for r, k in pairs]


def _decode_block(block):
    """Every point of a block decompressed and validated (curve and
    subgroup): [(bytes, x, y)], for the judge's decompression cache."""
    from cpref.host import serde
    from cpref.whisk import WhiskShuffleProof, _unzip_trackers

    pre, post, proof = block
    before = set(serde._CACHE)
    _unzip_trackers(_ref_trackers(pre))
    _unzip_trackers(_ref_trackers(post))
    with serde.deferred_subgroup_checks():
        WhiskShuffleProof.deserialize(proof, _REF["crs"].log2_n())
    return [(b, *p.to_affine()) for b, p in serde._CACHE.items()
            if b not in before]


def replay(crs, batch, seed: int, call: int):
    """The reference's batch verification of `batch` with the RNG of the
    program's call `call`: (verdict, the final MSM's affine point, or
    None where an eager check failed before it)."""
    from cpref.errors import VerificationError
    from cpref.host.rng import StdRng
    from cpref.msm_accumulator import MsmAccumulator
    from cpref.whisk import WhiskShuffleProof, _unzip_trackers

    rng = StdRng.seed_from_u64(sub_seed(seed, f"verify:{call}"))
    acc = MsmAccumulator()
    try:
        for pre, post, proof in batch:
            vec_r, vec_s = _unzip_trackers(_ref_trackers(pre))
            vec_t, vec_u = _unzip_trackers(_ref_trackers(post))
            wsp = WhiskShuffleProof.deserialize(proof, crs.log2_n())
            wsp.proof.verify_with_accumulator(crs, vec_r, vec_s, vec_t, vec_u,
                                              wsp.M, acc, rng)
    except VerificationError:
        return False, None
    point = acc.final_point()
    return point.is_infinity(), point.to_affine() or "inf"


def judge(rctx, ref, outputs) -> dict:
    from cpref.host import serde
    from cpref.host.g1 import G1

    crs = ref["crs"]
    _REF["crs"] = crs
    for pts in rctx.map(_decode_block, ref["blocks"]):
        serde._cache_put((b, G1.from_affine(x, y)) for b, x, y in pts)
    batches = _batches(ref["blocks"], _tampered_blocks(rctx.seed,
                                                       len(ref["blocks"])))
    calls = outputs["calls"]
    pick = random.Random(sub_seed(rctx.seed, "judge"))
    want, point_bad = {}, 0
    for kind in sorted({k for _, k, _, _ in calls}):
        call, _, _, point = pick.choice([c for c in calls if c[1] == kind])
        want[kind], ref_point = replay(crs, batches[kind], rctx.seed, call)
        point_bad += point != ref_point
    mism = sum(verdict != want[kind] for _, kind, verdict, _ in calls)
    expect = {"valid": True, "tampered_early": False, "tampered_late": False}
    return {"verdict_mismatches": (mism, 0),
            "msm_point_mismatches": (point_bad, 0),
            "kinds_unseen": (len(set(rctx.kinds) - set(want)), 0),
            "reference_wrong_verdicts": (
                sum(want[k] != expect[k] for k in want), 0)}


# --- the program's side (the timed process) ----------------------------------

class State:
    pass


def units(state, kind: str) -> int:
    return state.blocks


def setup(ctx, data) -> State:
    from curdleproofs_tpu_torch import whisk as pw

    st = State()
    st.ctx = ctx
    st.data = data
    st.blocks = ctx.params["blocks_per_batch"]
    bad = _tampered_blocks(ctx.seed, st.blocks)

    def trackers(pairs):
        return [pw.WhiskTracker(r, k) for r, k in pairs]

    blocks = [(trackers(pre), trackers(post), proof)
              for pre, post, proof in data["blocks"]]
    st.batches = _batches(blocks, bad)
    st.crs = program_crs(data["crs"])
    st.calls = 0
    st.half = False
    st.finals = {}
    if ctx.device != "cuda":
        from curdleproofs_tpu_torch.backend import set_backend
        from curdleproofs_tpu_torch.ops.backend import TorchBackend

        set_backend(TorchBackend(device=ctx.device))
    from curdleproofs_tpu_torch.backend import get_backend

    st.backend = get_backend()
    return st


def instrument(st) -> None:
    """The span of the backend's MSM call for each batch's final check,
    whose points are kept for the comparison; in a traced run the fold's
    least work."""
    from curdleproofs_tpu_torch.msm_accumulator import MsmAccumulator

    ctx = st.ctx
    st.in_final = False
    final_check = MsmAccumulator.verify

    def verify(acc):
        st.in_final = True
        try:
            return final_check(acc)
        finally:
            st.in_final = False

    MsmAccumulator.verify = verify
    from curdleproofs_tpu_torch import whisk
    from curdleproofs_tpu_torch.curdleproofs import CurdleproofsProof

    span_method(whisk, "_unzip_trackers", ctx.spans, "trackers")
    span_method(whisk.WhiskShuffleProof, "deserialize", ctx.spans, "proof_bytes")
    span_method(CurdleproofsProof, "verify_with_accumulator", ctx.spans, "replay")
    span_method(MsmAccumulator, "dedup_raw", ctx.spans, "dedup")
    be = st.backend
    for name in ("msm", "msm_raw"):   # raw scalar bytes, or ints when few
        def wrapped(points, scalars, _orig=getattr(be, name)):
            if not st.in_final:
                return _orig(points, scalars)
            with ctx.spans.span("final_msm"):
                out = _orig(points, scalars)
            st.finals.setdefault(st.calls, []).append(out)
            return out

        setattr(be, name, wrapped)
    install_fold_probe(ctx)


def run(st, kind: str) -> dict:
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.whisk import is_valid_whisk_shuffle_proofs

    st.calls += 1
    rng = StdRng.seed_from_u64(sub_seed(st.ctx.seed, f"verify:{st.calls}"))
    shuffles = st.batches[kind]
    if st.half:
        shuffles = shuffles[: st.blocks // 2]
    ok = is_valid_whisk_shuffle_proofs(rng, st.crs, shuffles)
    return {"verdict": bool(ok), "call": st.calls}


def run_control(st, kind: str) -> dict:
    """The reference in the program's place with one guarantee broken:
    every proof is replayed and its eager checks run, but the batch's
    final MSM check is skipped, so a batch is accepted without it."""
    from cpref.crs import CurdleproofsCrs
    from cpref.errors import VerificationError
    from cpref.host.rng import StdRng
    from cpref.msm_accumulator import MsmAccumulator
    from cpref.whisk import WhiskShuffleProof, _unzip_trackers

    if not hasattr(st, "ref_crs"):
        st.ref_crs = CurdleproofsCrs.generate_crs(st.ctx.cfg["ell"])
        st.ref_batches = _batches(st.data["blocks"], _tampered_blocks(
            st.ctx.seed, st.blocks))
    st.calls += 1
    rng = StdRng.seed_from_u64(sub_seed(st.ctx.seed, f"verify:{st.calls}"))
    crs = st.ref_crs
    acc = MsmAccumulator()
    try:
        for pre, post, proof in st.ref_batches[kind]:
            vec_r, vec_s = _unzip_trackers(_ref_trackers(pre))
            vec_t, vec_u = _unzip_trackers(_ref_trackers(post))
            wsp = WhiskShuffleProof.deserialize(proof, crs.log2_n())
            wsp.proof.verify_with_accumulator(crs, vec_r, vec_s, vec_t, vec_u,
                                              wsp.M, acc, rng)
    except VerificationError:
        return {"verdict": False, "call": st.calls}
    return {"verdict": True, "call": st.calls}


def _answer_altered(call):
    def altered(st, kind):
        out = call(st, kind)
        return {**out, "verdict": not out["verdict"]}
    return altered


def _half_batch(call):
    def half(st, kind):
        st.half = True
        return call(st, kind)
    return half


# faults planted under the timed path, for the tests: each must come out
# not correct
FAULTS = {"answer_altered": _answer_altered, "half_batch": _half_batch}


def report(st) -> list[str]:
    counts = getattr(st.backend, "engine_counts", None)
    return [f"msm engines: {counts}"] if counts is not None else []


def release(st) -> None:
    st.batches = None
    st.crs = None


def outputs(st, done) -> dict:
    """Each call's number, kind and verdict, and the affine point of its
    final MSM ("inf" at infinity; None where no final MSM ran)."""
    calls = []
    for kind, out in done:
        outs = st.finals.get(out["call"])
        point = None
        if outs:
            total = outs[0]
            for p in outs[1:]:
                total = total.add(p)
            point = point_affine(total) or "inf"
        calls.append((out["call"], kind, out["verdict"], point))
    return {"calls": calls}
