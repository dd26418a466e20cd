"""Cold start on the CPU: the background warm-up
(curdleproofs_tpu_torch.ops.warmup) against the reference's surface,
without a card; the launch counts it keeps apart
(`kernels.launches_into`); and the kernel wrappers' first call, which
imports no sympy."""

import contextlib
import os
import random
import subprocess
import sys
import threading

import pytest
import torch

from curdleproofs_tpu.ops import warmup as ref_warmup
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import warmup

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)


@pytest.fixture
def fresh(monkeypatch):
    """The warm-up module as a new process finds it."""
    monkeypatch.setattr(warmup, "_thread", None)
    monkeypatch.setattr(warmup, "_result", {})
    return warmup


def test_surface_is_the_reference_s():
    assert warmup.__all__ == ref_warmup.__all__
    for name in warmup.__all__:
        assert callable(getattr(warmup, name))


def test_without_a_card_records_the_error(fresh):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert fresh.wait_ready() == {}                 # nothing started yet
    fresh.start_background_init()
    t = fresh._thread
    r = fresh.wait_ready(timeout=120)
    assert not t.is_alive()
    assert "no CUDA device" in r["error"]
    assert "init_s" not in r and "total_s" not in r
    # the caller's own first device touch raises, as without the warm-up
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")


def test_second_start_starts_no_thread(fresh, monkeypatch):
    started = []
    gate = threading.Event()

    def worker(load):
        started.append(load)
        gate.wait(60)
        fresh._result["init_s"] = 0.0

    monkeypatch.setattr(fresh, "_init_worker", worker)
    fresh.start_background_init()
    first = fresh._thread
    before = threading.active_count()
    fresh.start_background_init(load_aot_families=False)
    fresh.start_background_init()
    assert fresh._thread is first
    assert threading.active_count() == before
    gate.set()
    assert fresh.wait_ready(timeout=60) == {"init_s": 0.0}
    assert started == [True]
    assert not first.is_alive()


def test_warm_entries_launch_on_a_card_only():
    with pytest.raises(ValueError, match="on a card"):
        K.warm_entries("cpu")


def test_launches_into_keeps_a_thread_apart(monkeypatch):
    """Launches counted inside `launches_into` go to its dict, from its
    thread only; every other launch, on any thread, to LAUNCHES.  The C
    entry and the stream are faked, so no card is needed."""
    monkeypatch.setattr(K, "_lib", lambda source, entry: lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(K, "LAUNCHES", {k: 0 for k in K.KERNELS})
    apart = {}
    n_threads, per = 8, 200
    barrier = threading.Barrier(n_threads + 1)

    def main_path():
        barrier.wait()
        for _ in range(per):
            K._launch("g1_add", torch.device("cpu"))

    def warm():
        with K.launches_into(apart):
            barrier.wait()
            for _ in range(per):
                K._launch("fq_mul", torch.device("cpu"))
                K._launch("g1_add", torch.device("cpu"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=main_path)
                   for _ in range(n_threads - 1)]
        threads.append(threading.Thread(target=warm))
        for t in threads:
            t.start()
        barrier.wait()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert apart == {"fq_mul": per, "g1_add": per}
    assert K.LAUNCHES["g1_add"] == (n_threads - 1) * per
    assert K.LAUNCHES["fq_mul"] == 0
    # outside the context this thread counts into LAUNCHES again
    with K.launches_into({}) as inner:
        K._launch("g1_sqrt", torch.device("cpu"))
    K._launch("g1_sqrt", torch.device("cpu"))
    assert inner == {"g1_sqrt": 1} and K.LAUNCHES["g1_sqrt"] == 1


def test_broadcast_shapes_is_torch_s():
    from curdleproofs_tpu_torch.ops.field import broadcast_shapes

    rng = random.Random(12)
    for _ in range(2000):
        shapes = [tuple(rng.choice((0, 1, 2, 3)) for _ in range(
            rng.randint(0, 3))) for _ in range(rng.randint(1, 4))]
        try:
            want = torch.broadcast_shapes(*shapes)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                broadcast_shapes(*shapes)
            continue
        assert broadcast_shapes(*shapes) == want, shapes


_NO_SYMPY = """
import sys
import torch
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops import kernels as K
from curdleproofs_tpu_torch.ops import msm_device as md
from curdleproofs_tpu_torch.ops.g1_ops import g1_infinity
torch.set_num_threads(1)
p = g1_infinity((3,), "cpu")
K.fq_mul(p.x.int(), p.y.int()[:, :1])
K.g1_add(p, p)
rng = StdRng.seed_from_u64(3)
md.msm_device([rng.rand_g1() for _ in range(9)], list(range(9)),
              device="cpu")
print("SYMPY", "sympy" in sys.modules)
"""


def test_kernel_wrappers_import_no_sympy():
    """A process's first kernel launch imported sympy (through
    torch.broadcast_shapes), seconds of a cold start; the wrappers and the
    MSM path now import none."""
    r = subprocess.run([sys.executable, "-c", _NO_SYMPY], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SYMPY False" in r.stdout
