"""The port's MSM pipeline against the host golden model on the edge cases
tests/test_msm_device.py and tests/test_device_bases.py pin for the JAX
package: digit skew, dead tails, all-zero and tiny inputs, bases reuse, the
recode, the shape families and the native base export.

Every MSM result is a group element, compared exactly."""

import random

import numpy as np
import pytest
import torch

from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import R
from curdleproofs_tpu_torch.host.g1 import G1
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import msm_device as md

# the suite runs several test workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

rnd = random.Random(3)


def test_msm_device_adversarial_digit_skew():
    """All-equal scalars put every entry of a window into ONE bucket: the
    deepest slot merge (log2(n/T) rounds)."""
    rng = StdRng.seed_from_u64(9)
    n = 96
    pts = [rng.rand_g1() for _ in range(n)]
    ss = [rnd.randrange(R)] * n
    assert md.msm_device(pts, ss, c=8, device="cpu") == HostBackend().msm(
        pts, ss)


def test_msm_device_no_dead_tail_regression():
    """Exact power-of-two n with fully live top-window digits (the reference
    once double-counted the last sorted entry here)."""
    rnd2 = random.Random(7)
    rng = StdRng.seed_from_u64(11)
    n = 64
    pts = [rng.rand_g1() for _ in range(n)]
    ss = [rnd2.randrange(R) for _ in range(n)]
    assert md.msm_device(pts, ss, c=8, device="cpu") == HostBackend().msm(
        pts, ss)


def test_msm_device_all_zero_and_tiny():
    rng = StdRng.seed_from_u64(11)
    pts = [rng.rand_g1() for _ in range(5)]
    cpu = "cpu"
    assert md.msm_device(pts, [0] * 5, device=cpu) == G1.infinity()
    assert md.msm_device([], [], device=cpu) == G1.infinity()
    assert md.msm_device(pts[:1], [3], device=cpu) == pts[0].mul(3)
    with pytest.raises(ValueError):
        md.msm_device(pts, [1] * 4, device=cpu)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, the entry points run on `cuda`; with no card
    they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from curdleproofs_tpu_torch.convert import device_bases_from_numpy
    from curdleproofs_tpu_torch.ops.backend import TorchBackend
    from curdleproofs_tpu_torch.ops.g1_ops import points_to_device

    pts = [StdRng.seed_from_u64(13).rand_g1() for _ in range(3)]
    z = np.zeros((12, 9), np.uint32)
    for call in (lambda: md.msm_device(pts, [1, 2, 3]),
                 lambda: md.DeviceBases(pts),
                 lambda: md.prepare_bases(pts),
                 lambda: points_to_device(pts),
                 lambda: device_bases_from_numpy(z, z, z[0], 3),
                 lambda: TorchBackend()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_device_bases_reuse_and_raw_scalars():
    rng = StdRng.seed_from_u64(12)
    pts = [rng.rand_g1() for _ in range(33)]
    bases = md.prepare_bases(pts, "cpu")
    assert md.prepare_bases(pts, "cpu") is bases  # id-cache hit
    assert isinstance(bases, md.DeviceBases)
    ss1 = [rnd.randrange(R) for _ in range(33)]
    ss2 = [rnd.randrange(R) for _ in range(33)]
    host = HostBackend()
    assert md.msm_device(bases, ss1) == host.msm(pts, ss1)
    raw = b"".join(s.to_bytes(32, "little") for s in ss2)
    assert md.msm_device(bases, raw) == host.msm(pts, ss2)


def test_signed_digits_recode():
    """sum_w d_w 2^(cw) == scalar and |d_w| <= 2^(c-1), for both widths."""
    ss = [rnd.randrange(R) for _ in range(17)] + [0, 1, R - 1, R >> 1]
    n = len(ss)
    limbs = torch.from_numpy(md._scalars_to_limbs(ss, n).astype(np.int32))
    for c in (8, 16):
        d = md._signed_digits(limbs, n, c).numpy().astype(np.int64)
        assert d.shape == (-(-255 // c), n)
        assert np.abs(d).max() <= 1 << (c - 1)
        for i, s in enumerate(ss):
            val = sum(int(d[w, i]) << (c * w) for w in range(d.shape[0]))
            assert val == s, f"c={c} scalar {i}"


def test_pick_params_shape_families():
    # the untuned switch, on the CPU (the shipped tune table is the card's)
    p = md.pick_params(1 << 16, device="cpu")
    assert p.c == 8 and p.s_pad % 512 == 0 and p.t_rows % 8 == 0
    assert md.pick_params(1 << 19, device="cpu").c == 16
    assert md.pick_params(1000).n == md.pick_params(1024).n
    with pytest.raises(ValueError):
        md.pick_params(100, c=12)


def test_export_matches_bigint_path():
    """The native exporter's resident layout (taken whenever the native
    runtime is built, as it is at first use) equals the bigint path's, bit
    for bit, including infinity inputs and shape-family padding."""
    rng = StdRng.seed_from_u64(11)
    pts = ([rng.rand_g1() for _ in range(30)] + [G1.infinity()]
           + [rng.rand_g1().add(rng.rand_g1()) for _ in range(30)])
    db = md.DeviceBases(pts, "cpu")
    padded = pts + [G1.infinity()] * (db.n - len(pts))
    ref = md._extend_packed(md.points_to_device(padded, "cpu"))
    for got, want in zip((db.ext_px, db.ext_py, db.ext_zb), ref):
        assert torch.equal(got, want)
