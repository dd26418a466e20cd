"""The port's sharded MSM (curdleproofs_tpu_torch.parallel.sharded_msm) on
grids of CPU devices, the counterpart of conftest's 8 virtual CPU devices:

- the five grid cases of tests/test_parallel.py (matches host, window axis,
  ragged and small, sub-mesh, non-power-of-two points axis), each equal to
  the host MSM;
- on the window-axis grid (4, 2), whose points axis reduces by the
  butterfly, and on the (6, 1) grid, whose cells' canonical sums go to the
  host, the port's per-cell window sums against the JAX package's
  `_sharded_step` on the same seed-made inputs, with the same static
  arguments as tests/test_parallel.py's runs;
- the sizing (c, the local and padded sizes, the window split, the slot
  depth and bound, the butterfly switch, the ValueError), equal to the JAX
  package's over a table of (n_total, Dp, Dw);
- `CURDLEPROOFS_MADD=0` running the full-add fold.

Tolerances: exact equality of points, and of the sizing.  Window sums
compare after affine normalization: the port sorts with
`torch.sort(stable=True)`, the reference's `lax.sort` is not asked to be
stable, so entries of one bucket may fold in another order."""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curdleproofs_tpu.parallel.sharded_msm as jsm
from curdleproofs_tpu.host.g1 import G1 as JG1
from curdleproofs_tpu.host.rng import StdRng as JStdRng
from curdleproofs_tpu.host.serde import g1_to_bytes as j_g1_to_bytes
from curdleproofs_tpu.ops import g1_ops as jg1
from curdleproofs_tpu.ops import msm_device as jmd
from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import R
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.host.serde import g1_to_bytes
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.parallel import sharded_msm as sm

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def points64():
    rng = StdRng.seed_from_u64(11)
    return [rng.rand_g1() for _ in range(64)]


def _sizing(run) -> dict:
    """The sizes a `sharded_msm_kernel` callable was built with, read from
    its closure (the same names in both packages)."""
    cells = dict(zip(run.__code__.co_freevars,
                     (c.cell_contents for c in run.__closure__)))
    return {k: cells[k] for k in ("c", "n_local", "n_pad", "w_local",
                                  "w_total", "t_rows", "s_pad",
                                  "device_reduce")}


def _ref_cells(nd, dw, n, scalars, sizes) -> list[list[bytes]]:
    """The JAX package's `_sharded_step` on its `make_msm_mesh(nd, dw)` of
    conftest's virtual CPU devices, as its `sharded_msm_kernel` calls it:
    per (row, column) cell, its window sums as affine bytes."""
    jrng = JStdRng.seed_from_u64(11)
    jpts = [jrng.rand_g1() for _ in range(64)][:n]
    n_pad = sizes["n_pad"]
    pts = jg1.points_to_device(jpts + [JG1.infinity()] * (n_pad - n))
    limbs = jnp.asarray(jmd._scalars_to_limbs(scalars, n_pad))
    out = np.asarray(jsm._sharded_step(
        pts, limbs, mesh=jsm.make_msm_mesh(nd, n_window_shards=dw),
        n_local=sizes["n_local"], c=sizes["c"], w_local=sizes["w_local"],
        t_rows=sizes["t_rows"], s_pad=sizes["s_pad"],
        pallas=jg1.use_pallas(), device_reduce=sizes["device_reduce"]))
    return [[[j_g1_to_bytes(p) for p in jmd._window_sums_to_host(cell)]
             for cell in row] for row in out]


@pytest.mark.parametrize("nd, dw, n, shape, against_reference", [
    pytest.param(8, 1, 64, (8, 1), False, id="matches_host"),
    pytest.param(8, 2, 64, (4, 2), True, id="window_axis"),
    pytest.param(8, 1, 11, (8, 1), False, id="ragged_and_small"),
    pytest.param(4, 1, 64, (4, 1), False, id="sub_mesh"),
    pytest.param(6, 1, 64, (6, 1), True, id="non_pow2_points_axis"),
])
def test_sharded_msm_on_cpu_grids(points64, monkeypatch, nd, dw, n, shape,
                                  against_reference):
    """The sub-mesh case goes through the package's lazy exports, with the
    scalars as canonical 32-byte buffers."""
    from curdleproofs_tpu_torch import parallel

    rnd = random.Random(100 * nd + 10 * dw + n)
    pts = points64[:n]
    scalars = [rnd.randrange(R) for _ in range(n)]
    scalars[0] = R - 1
    mesh = parallel.make_msm_mesh(nd, n_window_shards=dw, devices=CPU8)
    assert mesh.devices.shape == shape
    assert mesh.axis_names == ("points", "windows")

    cells = []
    step = sm._sharded_step

    def spy(*a, **kw):
        cells.append(step(*a, **kw))
        return cells[-1]

    monkeypatch.setattr(sm, "_sharded_step", spy)
    kernel = parallel.sharded_msm_kernel(mesh, n)
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    got = kernel(pts, raw if shape == (4, 1) else scalars)
    assert got == HostBackend().msm(pts, scalars)
    sizes = _sizing(kernel)
    assert sizes["device_reduce"] == (shape[0] in (2, 4, 8))
    (rows,) = cells
    assert len(rows) == (1 if sizes["device_reduce"] else shape[0])
    assert all(len(r) == dw and all(t.shape == (3, 24, sizes["w_local"])
                                    for t in r) for r in rows)
    if against_reference:
        got = [[[g1_to_bytes(p) for p in md._window_sums_to_host(t.numpy())]
                for t in row] for row in rows]
        assert got == _ref_cells(nd, dw, n, scalars, sizes)


def test_sharded_msm_lazy_exports():
    """The package's lazy exports (`sharded_msm` is the submodule)."""
    from curdleproofs_tpu_torch import parallel

    assert parallel.sharded_msm is sm
    assert parallel.sharded_msm_kernel is sm.sharded_msm_kernel
    assert parallel.make_msm_mesh is sm.make_msm_mesh


def test_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sm.make_msm_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sm.sharded_msm([], [])
    with pytest.raises(ValueError, match="non-empty"):
        sm.make_msm_mesh(devices=[])


@pytest.mark.parametrize("n_total, dp, dw, c", [
    (0, 1, 1, None), (11, 8, 1, None), (64, 8, 2, None), (64, 6, 1, None),
    (1000, 3, 1, None), (100_000, 2, 4, None), ((1 << 18) - 1, 4, 2, None),
    (1 << 18, 4, 2, None), (626_000, 4, 2, None), (626_000, 8, 1, None),
    (626_000, 16, 1, None), (5000, 4, 1, 16), (1 << 18, 1, 16, None),
    (100, 1, 3, None), (1 << 18, 2, 3, None), (64, 1, 5, 16),
])
def test_sizing_equals_the_reference(n_total, dp, dw, c):
    stub = types.SimpleNamespace(devices=np.empty((dp, dw), dtype=object))
    try:
        want = _sizing(jsm.sharded_msm_kernel(stub, n_total, c))
    except ValueError as e:
        with pytest.raises(ValueError, match="must divide"):
            sm.sharded_msm_kernel(stub, n_total, c)
        assert "must divide" in str(e)
        return
    assert _sizing(sm.sharded_msm_kernel(stub, n_total, c)) == want
    assert sm._pick_c(n_total) == jsm._pick_c(n_total)


def test_madd_switch_runs_the_full_add_fold(points64, monkeypatch):
    """CURDLEPROOFS_MADD=0: the cell folds with the full add, counted by
    the plain versions' calls (the CPU runs them in place of the kernels)."""
    counts = {"g1_fold_madd_plain": 0, "g1_fold_packed_plain": 0}
    for name in counts:
        def counted(*a, _n=name, _f=getattr(K, name)):
            counts[_n] += 1
            return _f(*a)

        monkeypatch.setattr(K, name, counted)
    monkeypatch.setenv("CURDLEPROOFS_MADD", "0")
    rnd = random.Random(5)
    scalars = [rnd.randrange(R) for _ in range(20)]
    mesh = sm.make_msm_mesh(1, devices=CPU8)
    got = sm.sharded_msm(points64[:20], scalars, mesh)
    assert got == HostBackend().msm(points64[:20], scalars)
    assert counts == {"g1_fold_madd_plain": 0, "g1_fold_packed_plain": 1}
