"""The input makers at a tiny width (ell = 4, n = 8): what they make is
valid under the reference, tampered where it should be, the same for the
same seed, and handed to the program as the same values."""

import json

import pytest

from conftest import BENCH
from harness.core import Context, load_module
from harness.refproc import RefContext
from harness.trace import Spans

SEED = 2**31 + 17


def _make(root, entry, mix, seed=SEED):
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "tiny_l4.json").read_text())
    mixd = json.loads((b / "traffic" / f"{mix}.json").read_text())
    mod = load_module(BENCH / "entries" / f"{entry}.py", f"t_{entry}")
    rctx = RefContext(cfg, mixd["params"], seed, tuple(sorted(mixd["period"])), 1)
    data, ref = mod.make_inputs(rctx)
    ctx = Context(root, cfg, mixd["params"], seed, "cpu", False, Spans(False))
    return mod, data, ref, mod.setup(ctx, data)


def test_sync_blocks(tiny_root):
    from cpref.host.rng import StdRng
    from cpref.whisk import is_valid_whisk_shuffle_proof

    mod, data, ref, st = _make(tiny_root, "whisk_batch_verify", "tiny_sync")
    assert st.blocks == 4 and len(ref["blocks"]) == 4
    rng = StdRng.seed_from_u64(1)
    trk = mod._ref_trackers
    for pre, post, proof in ref["blocks"]:
        assert len(pre) == 4 and len(post) == 4
        assert is_valid_whisk_shuffle_proof(rng, ref["crs"], trk(pre),
                                            trk(post), proof)
    bad = mod._tampered_blocks(SEED, 4)
    assert bad["tampered_early"] < 2 <= bad["tampered_late"]
    batches = mod._batches(ref["blocks"], bad)
    for kind, i in bad.items():
        pre, post, proof = batches[kind][i]
        assert proof != ref["blocks"][i][2]
        assert not is_valid_whisk_shuffle_proof(rng, ref["crs"], trk(pre),
                                                trk(post), proof)
        assert [b for j, b in enumerate(batches[kind]) if j != i] == \
            [b for j, b in enumerate(ref["blocks"]) if j != i]
    # the program gets the same bytes, and the same CRS
    for kind, blocks in st.batches.items():
        assert [b[2] for b in blocks] == [b[2] for b in batches[kind]]
        assert [t.r_G for t in blocks[0][0]] == \
            [r for r, _ in batches[kind][0][0]]
    assert [(p.x, p.y) for p in st.crs.vec_G] == \
        [p.to_affine() for p in ref["crs"].vec_G]
    # fresh pre-trackers a block, the same for the same seed only
    assert ref["blocks"][0][0][0] != ref["blocks"][1][0][0]
    _, again, _, _ = _make(tiny_root, "whisk_batch_verify", "tiny_sync")
    assert again["blocks"] == data["blocks"]
    _, other, _, _ = _make(tiny_root, "whisk_batch_verify", "tiny_sync", SEED + 1)
    assert other["blocks"][0][2] != data["blocks"][0][2]


def test_reference_replay_matches_its_own_verifier(tiny_root):
    """The judge's batch replay accepts the valid batch with the identity
    as its final point and rejects a tampered one by its final MSM."""
    mod, data, ref, st = _make(tiny_root, "whisk_batch_verify", "tiny_sync")
    batches = mod._batches(ref["blocks"], mod._tampered_blocks(SEED, 4))
    assert mod.replay(ref["crs"], batches["valid"], SEED, 1) == (True, "inf")
    ok, point = mod.replay(ref["crs"], batches["tampered_late"], SEED, 1)
    assert ok is False and isinstance(point, tuple)


def test_relay_instances(tiny_root):
    from cpref.backend import HostBackend
    from cpref.util import get_permutation, msm

    mod, data, ref, st = _make(tiny_root, "batch_prove", "tiny_relay")
    assert st.B == 4 == ref["B"] and sorted(st.sample) == st.sample
    assert st.sample == ref["sample"]
    assert [i // (st.B // 4) for i in st.sample] == [0, 1, 2, 3]
    assert len(st.inputs) == st.B
    hb = HostBackend()
    for i in range(st.B):
        R_, S, T, U, M, perm, k, blinders, _ = mod._ref_instance(ref["crs"], SEED, i)
        want_t = get_permutation(hb.batch_mul(R_, k), perm)
        assert [p.to_affine() for p in want_t] == [p.to_affine() for p in T]
        sigma = get_permutation(list(range(4)), perm)
        m = msm(ref["crs"].vec_G, sigma).add(msm(ref["crs"].vec_H, blinders))
        assert m.to_affine() == M.to_affine() == tuple(st.inputs[i][4])
    assert len({seed for *_, seed in st.inputs}) == st.B
    # each wave's objects are new, with the reference's coordinates
    a, b = mod._instances(st, st.B), mod._instances(st, st.B)
    assert a[0].vec_R[0] is not b[0].vec_R[0]
    i = st.sample[0]
    T = mod._ref_instance(ref["crs"], SEED, i)[2]
    assert [(p.x, p.y) for p in a[i].vec_T] == [p.to_affine() for p in T]
    assert a[0].rng is not b[0].rng


def test_tamper_keeps_the_scalar_canonical():
    from cpref.constants import R

    mod = load_module(BENCH / "entries" / "whisk_batch_verify.py", "t_tamper")
    out = mod._tamper(b"\0" * 16 + (5).to_bytes(32, "little"))
    assert int.from_bytes(out[-32:], "little") == 4
    # R - 1 ends in a zero byte: every flip there leaves the field
    with pytest.raises(ValueError):
        mod._tamper((R - 1).to_bytes(32, "little"))
