"""The port's CURDLEPROOFS_BACKEND mapping (`backend._backend_from_env`):
the cases of `tests/test_backend_env.py` that apply to the port, with the
port's own `torch`, which stays the default.

The card backends (`torch`, `hybrid`, `tpu`, `auto`) are built on `cuda`:
without a card each name still resolves to its class, whose construction
raises, so the mapping is pinned by the class the error comes from.  `auto`
raising without a card is the one deliberate difference from the JAX
package, whose `auto` falls back to the host backend.  An unknown name
raises."""

import os
from unittest import mock

import pytest
import torch

from curdleproofs_tpu_torch import backend as backend_mod
from curdleproofs_tpu_torch.backend import (
    HostBackend, PurePythonBackend, _backend_from_env,
)
from curdleproofs_tpu_torch.ops import backend as ops_backend
from curdleproofs_tpu_torch.ops.backend import (
    DeviceBackend, HybridBackend, TorchBackend,
)

torch.set_num_threads(1)


def _resolve(value: str | None):
    env = {} if value is None else {"CURDLEPROOFS_BACKEND": value}
    with mock.patch.dict(os.environ, env, clear=False):
        if value is None:
            os.environ.pop("CURDLEPROOFS_BACKEND", None)
        return _backend_from_env()


@pytest.fixture
def on_cpu(monkeypatch):
    """Card backends built on the CPU: `resolve_device` in ops/backend.py
    maps `cuda` to `cpu`, so each name's class can be constructed here."""
    real = ops_backend.resolve_device
    monkeypatch.setattr(ops_backend, "resolve_device",
                        lambda device="cuda": real("cpu"))


@pytest.mark.parametrize("value, cls", [
    ("hybrid", HybridBackend), ("tpu", DeviceBackend),
    ("torch", TorchBackend), (None, TorchBackend), ("auto", HybridBackend),
    ("HYBRID", HybridBackend),
])
def test_env_card_names_build_their_backend(on_cpu, value, cls):
    assert type(_resolve(value)) is cls


def test_env_host_and_pure():
    assert type(_resolve("host")) is HostBackend
    assert type(_resolve("pure")) is PurePythonBackend
    assert type(_resolve("python")) is PurePythonBackend


@pytest.mark.parametrize("value", ["torch", "hybrid", "tpu", "auto", None])
def test_env_card_backends_raise_without_a_card(value, monkeypatch):
    """Without a card every card backend raises, `auto` included (the
    reference's `auto` resolves to the host backend there)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _resolve(value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops_backend.auto_backend()


def test_env_unknown_name_raises():
    for value in ("gpu", "cuda", ""):
        with pytest.raises(ValueError, match="unknown CURDLEPROOFS_BACKEND"):
            _resolve(value)


def test_get_backend_resolves_lazily_and_caches():
    old = backend_mod._active
    try:
        backend_mod._active = None
        with mock.patch.dict(os.environ, {"CURDLEPROOFS_BACKEND": "host"}):
            got = backend_mod.get_backend()
        assert got is backend_mod.get_backend()
        assert type(got) is HostBackend
    finally:
        backend_mod._active = old


def test_fused_prove_loops_by_backend(on_cpu):
    """The reference runs the fused native prove loops under every backend;
    the port's TorchBackend turns them off so that the folding rounds'
    MSMs reach the card, and the reference's two device backends keep
    them."""
    assert HostBackend().native_prove_loops
    assert PurePythonBackend().native_prove_loops
    assert not TorchBackend().native_prove_loops
    assert HybridBackend().native_prove_loops
    assert DeviceBackend().native_prove_loops


def test_active_device_follows_every_device_backend():
    for cls in (TorchBackend, HybridBackend, DeviceBackend):
        with backend_mod.use_backend(cls(device="cpu")):
            assert ops_backend.active_device() == torch.device("cpu")
