"""The plain reference (`benchmark/cpref`): bit-exact with the Rust
reference's golden proof, built inside the benchmark, and free of the
program and of JAX."""

import subprocess
import sys

from conftest import BENCH, ROOT


def test_golden_whisk_shuffle_proof():
    from cpref.constants import WHISK_ELL
    from cpref.crs import CurdleproofsCrs
    from cpref.host.rng import StdRng
    from cpref.whisk import (WhiskTracker, generate_whisk_shuffle_proof,
                             is_valid_whisk_shuffle_proof)

    rng = StdRng.seed_from_u64(0)
    crs = CurdleproofsCrs.generate_crs(WHISK_ELL)
    pre = [WhiskTracker.from_rand(rng) for _ in range(WHISK_ELL)]
    post, proof = generate_whisk_shuffle_proof(rng, crs, pre)
    golden = (ROOT / "tests" / "golden" / "whisk_shuffle_proof_128.hex"
              ).read_text().strip()
    assert proof.hex() == golden
    assert is_valid_whisk_shuffle_proof(rng, crs, pre, post, proof)
    bad = bytearray(proof)
    bad[-32] ^= 1
    assert not is_valid_whisk_shuffle_proof(rng, crs, pre, post, bytes(bad))


def test_plain_build_lies_in_the_benchmark_keyed_by_its_sources():
    from cpref.host import plain

    assert plain.build().parent == plain.BUILD_DIR
    assert plain.BUILD_DIR.parent == BENCH / "_build" / "cpref-plain"
    assert plain.BUILD_DIR.name == plain._source_key()


def test_plain_arithmetic_matches_python_ints():
    """plain.c's scalar multiplications, folds and MSM against the
    group law on Python ints."""
    import random

    from cpref.constants import R
    from cpref.host import plain
    from cpref.host.g1 import GENERATOR, G1

    rnd = random.Random(7)

    def slow_mul(p, s):
        acc = G1.infinity()
        for bit in bin(s)[2:]:
            acc = acc.double()
            if bit == "1":
                acc = acc.add(p)
        return acc

    pts = [slow_mul(GENERATOR, rnd.randrange(1, R)) for _ in range(5)]
    pts.append(G1.infinity())
    sc = [rnd.randrange(R) for _ in pts[:-2]] + [0, rnd.randrange(R)]
    want = [slow_mul(p, s) for p, s in zip(pts, sc)]
    assert plain.mul_each(pts, sc) == want
    assert plain.fold_each(pts, pts[::-1], sc) == [
        a.add(slow_mul(b, s)) for a, b, s in zip(pts, pts[::-1], sc)]
    total = G1.infinity()
    for w in want:
        total = total.add(w)
    for n in (1, 2, 6, 40):
        many = (pts * 7)[:n]
        scs = [rnd.randrange(R) for _ in many]
        acc = G1.infinity()
        for p, s in zip(many, scs):
            acc = acc.add(slow_mul(p, s))
        assert plain.msm(many, scs) == acc
    assert plain.in_subgroup(pts) == [True] * len(pts)
    off = G1.from_affine(4, 0x0a989badd40d6212b33cffc3f3763e9bc760f988c9926b26da9dd85e928483446346b8ed00e1de5d5ea93e354abe706c)
    assert off.is_on_curve() and plain.in_subgroup([off]) == [False]


def test_reference_loads_neither_program_nor_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark'); "
            "import cpref.whisk, cpref.curdleproofs, cpref.backend; "
            "cpref.host.plain.lib(); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    tops = set(eval(out))
    assert not tops & {"curdleproofs_tpu_torch", "curdleproofs_tpu", "jax",
                       "jaxlib", "flax", "torch"}


def test_yardstick_constants_match_the_field():
    from cpref.constants import Q
    from curdleproofs_tpu_torch.ops.field import FQ
    from harness import yardstick

    assert yardstick.Q == Q
    assert yardstick.ONE_MONT == FQ.one_mont
