"""Two switches of the JAX package's surface that the port must honour.

- The package's lazy API: every name `curdleproofs_tpu.__getattr__`
  resolves must resolve in `curdleproofs_tpu_torch` too.  The names are
  read from the reference's source text, so the reference is not imported.
- `CURDLEPROOFS_MADD=0` selects the full-add bucket fold wherever `madd`
  is not given, as the reference's `use_madd()` does: `msm_device`,
  `DeviceMsmStream` and the batched prover's dispatcher.  Fold calls are
  counted through the plain versions, which the CPU runs in place of the
  kernels.  Results compare exactly with the host MSM."""

import ast
import pathlib
import random

import pytest
import torch

import curdleproofs_tpu_torch
from curdleproofs_tpu_torch.backend import HostBackend
from curdleproofs_tpu_torch.constants import R
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.parallel import batch_prove as bp

torch.set_num_threads(1)

REF_INIT = (pathlib.Path(__file__).resolve().parents[1] / "curdleproofs_tpu"
            / "__init__.py")


def _reference_lazy_names() -> set[str]:
    """String constants compared with `name` in the reference's
    module-level `__getattr__`."""
    tree = ast.parse(REF_INIT.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) \
                and node.left.id == "name":
            for c in ast.walk(node):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    names.add(c.value)
    return names


def test_lazy_api_resolves_every_reference_name():
    names = _reference_lazy_names()
    assert {"CurdleproofsProof", "is_valid_whisk_shuffle_proofs",
            "StdRng"} <= names
    missing = sorted(n for n in names
                     if not hasattr(curdleproofs_tpu_torch, n))
    assert missing == []


@pytest.fixture
def fold_calls(monkeypatch):
    counts = {"g1_fold_madd_plain": 0, "g1_fold_packed_plain": 0}
    for name in counts:
        def counted(*a, _n=name, _f=getattr(K, name)):
            counts[_n] += 1
            return _f(*a)

        monkeypatch.setattr(K, name, counted)
    return counts


@pytest.fixture(scope="module")
def inputs():
    rng = StdRng.seed_from_u64(21)
    rnd = random.Random(21)
    pts = [rng.rand_g1() for _ in range(9)]
    return pts, [rnd.randrange(R) for _ in pts]


@pytest.mark.parametrize("flag, fold", [
    ("0", "g1_fold_packed_plain"), (None, "g1_fold_madd_plain")])
def test_madd_switch_on_msm_device_and_stream(inputs, fold_calls, monkeypatch,
                                              flag, fold):
    if flag is None:
        monkeypatch.delenv("CURDLEPROOFS_MADD", raising=False)
    else:
        monkeypatch.setenv("CURDLEPROOFS_MADD", flag)
    pts, ss = inputs
    want = HostBackend().msm(pts, ss)
    assert md.use_madd() is (flag is None)
    assert md.msm_device(pts, ss, device="cpu") == want
    stream = md.DeviceMsmStream(64, device="cpu")
    assert stream.madd is (flag is None)
    stream.add(pts, ss)
    assert stream.result() == want
    assert fold_calls == {"g1_fold_madd_plain": 0,
                          "g1_fold_packed_plain": 0, fold: 2}
    # an explicit argument wins over the switch
    assert md.DeviceMsmStream(64, device="cpu",
                              madd=flag is not None).madd is (flag is not None)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_madd_switch_on_the_batched_prover(inputs, monkeypatch, flag):
    monkeypatch.setenv("CURDLEPROOFS_MADD", flag)
    monkeypatch.setenv("CURDLEPROOFS_TABLE", "0")  # no table build
    bases = md.DeviceBases(inputs[0], "cpu")
    assert bp._Dispatcher(bases).madd is (flag == "1")
    assert bp._Dispatcher(bases, madd=True).madd is True
    for fn in (bp.batch_prove, bp._prove_wave):
        assert fn.__defaults__[-2:] == (None, None)  # madd, mark
