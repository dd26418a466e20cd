"""The port's recorder (`curdleproofs_tpu_torch/utils/trace.py`) and the
spans and counters the program puts where its work happens, on the CPU.

- the recorder: parent ids and the call id on two threads and on a work
  thread that runs in its submitter's context, self time, the bound and
  `trace.dropped`, nothing recorded while off (the `acc=` seconds still
  added), each span a `cp/<name>` `user_annotation` range nested in its
  caller's in a CPU `torch.profiler` trace (a `timeline=False` span
  recorded, with no range), and the exit summary under
  `CURDLEPROOFS_TRACE=1` (one, with the spans' attribute totals and the
  counters, and no line a span);
- the program: a small `is_valid_whisk_shuffle_proofs` batch on
  `TorchBackend(device="cpu")` records one `whisk.unzip_trackers` span a
  batch, 4 x ell x blocks points decompressed, no decompress-cache
  hit with the cache off, and the MSM pipeline's spans under its final
  check; a `batch_prove` wave's `dispatch.*` spans sum to its
  `last_timings`' stages, whose keys and identity stay as they were.

Tolerance: exact, but for the sums of the dispatch stages (1%)."""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from curdleproofs_tpu_torch.backend import HostBackend, use_backend
from curdleproofs_tpu_torch.curdleproofs import generate_crs
from curdleproofs_tpu_torch.host import serde
from curdleproofs_tpu_torch.host.g1 import GENERATOR
from curdleproofs_tpu_torch.host.rng import StdRng
from curdleproofs_tpu_torch.ops.backend import TorchBackend
from curdleproofs_tpu_torch.ops.msm_device import DeviceMsmStream
from curdleproofs_tpu_torch.parallel import batch_prove as bp
from curdleproofs_tpu_torch.utils import trace
from curdleproofs_tpu_torch.whisk import (
    WhiskTracker, generate_whisk_shuffle_proof, is_valid_whisk_shuffle_proofs,
)

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts with an empty recorder that is off, and leaves it
    so for the tests after it in this worker."""
    trace.enable(False)
    trace.reset()
    yield trace
    trace.enable(False)
    trace.reset()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def test_nesting_parents_and_call_ids_on_two_threads():
    trace.enable()
    barrier = threading.Barrier(2)

    def call(tag):
        with trace.span(f"{tag}.root"):
            barrier.wait()
            with trace.span(f"{tag}.child", tag=tag):
                with trace.span(f"{tag}.leaf"):
                    barrier.wait()

    threads = [threading.Thread(target=call, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = {r.name: r for r in trace.records()}
    assert len(recs) == 6
    for tag in "ab":
        root, child, leaf = (recs[f"{tag}.{n}"]
                             for n in ("root", "child", "leaf"))
        assert root.parent is None and root.call == root.id
        assert child.parent == root.id and leaf.parent == child.id
        assert child.call == leaf.call == root.id
        assert child.attrs == {"tag": tag} and root.attrs is None
        assert root.tid == child.tid == leaf.tid
        assert root.t0_ns <= child.t0_ns <= leaf.t0_ns <= leaf.t1_ns \
            <= child.t1_ns <= root.t1_ns
    assert recs["a.root"].call != recs["b.root"].call
    assert recs["a.root"].tid != recs["b.root"].tid


def test_threads_lose_no_record_and_no_count():
    """More threads than cores, switching often: every span arrives with
    an id of its own, and every count."""
    trace.enable()
    n_threads, each = 4 * (os.cpu_count() or 1), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with trace.span("s"):
                    trace.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = trace.records()
    assert len(recs) == n_threads * each
    assert len({r.id for r in recs}) == len(recs)
    assert trace.counters() == {"n": n_threads * each}


def test_a_work_thread_in_the_submitters_context_keeps_the_call_id():
    rng = StdRng.seed_from_u64(7)
    pts = [rng.rand_g1() for _ in range(9)]
    trace.enable()
    with trace.span("root") as root:
        trace.enable(False)   # from here on only the open root records
        s = DeviceMsmStream(64, async_worker=True, device="cpu")
        s.add(pts, list(range(9)))
        s.result()
    recs = _by_name(trace.records())
    (bases,) = recs["msm.bases"]
    assert bases.tid != threading.get_ident()
    assert bases.call == root.id
    assert recs["msm.horner"][0].call == root.id


def test_self_time_subtracts_the_covered_part_of_the_children():
    R = trace.Record
    recs = [R(1, None, 1, "root", 0, 100, 1, None),
            R(2, 1, 1, "a", 10, 30, 1, None),
            R(3, 1, 1, "b", 20, 50, 2, None),     # overlaps a (other thread)
            R(4, 1, 1, "c", 90, 120, 2, None),    # runs past the root's end
            R(5, 2, 1, "a.a", 12, 14, 1, None)]
    assert trace.self_times(recs) == {1: 100 - 40 - 10, 2: 18, 3: 30,
                                      4: 30, 5: 2}
    text = trace.summary(recs, {"points": 3})
    rows = {ln.split()[0]: ln.split()[1:] for ln in text.splitlines()[1:]}
    assert rows["root"] == ["1", "0.000", "0.000"]
    assert rows["points"] == ["3"]


def test_the_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("s"):
            pass
    assert len(trace.records()) == 3
    assert trace.counters() == {"trace.dropped": 2}
    trace.reset()
    assert trace.records() == [] and trace.counters() == {}


def test_off_records_nothing_but_acc_still_adds():
    acc = {}
    assert not trace.trace_enabled()
    assert trace.span("a") is trace.span("b")   # the shared no-op
    with trace.span("a", acc=acc, key="k"):
        with trace.span("b"):
            trace.count("n", 5)
    with trace.span("a", acc=acc, key="k"):
        pass
    assert trace.records() == [] and trace.counters() == {}
    assert set(acc) == {"k"} and acc["k"] > 0
    trace.enable()
    before = acc["k"]
    with trace.span("a", acc=acc, key="k") as s:
        trace.count("n", 5)
    (rec,) = trace.records()
    assert acc["k"] - before == pytest.approx((rec.t1_ns - rec.t0_ns) * 1e-9)
    assert s.id == rec.id and trace.counters() == {"n": 5}


def test_spans_are_ranges_on_the_profilers_timeline(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.trace_enabled()
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()
                with trace.span("item", timeline=False):
                    pass
    assert not trace.trace_enabled()
    with trace.span("after"):
        pass
    recs = {r.name: r for r in trace.records()}
    assert set(recs) == {"outer", "inner", "item"}
    assert recs["inner"].parent == recs["outer"].id
    assert recs["item"].parent == recs["inner"].id
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("ph") == "X" and e.get("name", "").startswith("cp/")}
    assert set(ranges) == {"cp/outer", "cp/inner"}
    out, inn = ranges["cp/outer"], ranges["cp/inner"]
    assert out["cat"] == inn["cat"] == "user_annotation"
    assert out["tid"] == inn["tid"]
    assert out["ts"] <= inn["ts"]
    assert inn["ts"] + inn["dur"] <= out["ts"] + out["dur"]


_SCRIPT = """
import sys
from curdleproofs_tpu_torch.utils.trace import count, span
from curdleproofs_tpu_torch import whisk  # noqa: F401, the protocol layer
for _ in range(3):
    with span("outer"):
        with span("inner", items=2):
            count("things", 2)
print("torch loaded" if "torch" in sys.modules else "no torch")
"""


@pytest.mark.parametrize("env", ["1", None])
def test_the_exit_summary_under_the_switch(env):
    environ = {k: v for k, v in os.environ.items()
               if k != "CURDLEPROOFS_TRACE"}
    if env is not None:
        environ["CURDLEPROOFS_TRACE"] = env
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=_REPO,
                          env=environ, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    # importing the protocol layer and tracing it loads no torch
    assert proc.stdout.strip() == "no torch"
    lines = [ln for ln in proc.stderr.splitlines() if "[trace]" in ln
             or ln.split()[:1] in (["outer"], ["inner"], ["inner.items"],
                                   ["things"])]
    if env is None:
        assert lines == []
        return
    assert len([ln for ln in lines if "[trace]" in ln]) == 1
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:]}
    assert rows["outer"][0] == rows["inner"][0] == "3"
    assert rows["inner.items"] == ["6"]
    assert rows["things"] == ["6"]


# --------------------------------------------------------------------------
# the program's spans
# --------------------------------------------------------------------------

ELL, BLOCKS = 4, 2


@pytest.fixture(scope="module")
def blocks():
    """Two Whisk blocks at l = 4, each with fresh pre-trackers."""
    rng = StdRng.seed_from_u64(41)
    crs = generate_crs(ELL)
    out = []
    with use_backend(HostBackend()):
        for _ in range(BLOCKS):
            pre = []
            for _ in range(ELL):
                k, r = rng.rand_fr(), rng.rand_fr()
                r_G = GENERATOR.mul(r)
                pre.append(WhiskTracker(serde.g1_to_bytes(r_G),
                                        serde.g1_to_bytes(r_G.mul(k))))
            post, proof = generate_whisk_shuffle_proof(rng, crs, pre)
            out.append((pre, post, proof))
    return crs, out


def test_sync_verification_spans_and_counters(blocks, monkeypatch):
    monkeypatch.setenv("CP_NO_DECOMPRESS_CACHE", "1")
    crs, shuffles = blocks
    trace.enable()
    with use_backend(TorchBackend(device="cpu")) as backend:
        assert is_valid_whisk_shuffle_proofs(StdRng.seed_from_u64(5), crs,
                                             shuffles) is True
    assert backend.engine_counts["device"] == 1
    recs = trace.records()
    names = _by_name(recs)
    (root,) = names["whisk.verify_batch"]
    assert root.parent is None and all(r.call == root.id for r in recs)
    assert len(names["whisk.unzip_trackers"]) == 1
    assert sum(r.attrs["points"] for r in names["whisk.unzip_trackers"]) \
        == 4 * ELL * BLOCKS
    totals = trace.attr_totals(recs)
    assert totals["whisk.unzip_trackers.points"] == 4 * ELL * BLOCKS
    assert "g1.decompress_cache_hits" not in trace.counters()
    assert len(names["verify.replay"]) == BLOCKS
    (ladder,) = names["g1.subgroup_ladder"]
    assert totals["g1.subgroup_ladder.points"] == ladder.attrs["points"] > 0
    ids = {r.id: r for r in recs}
    (final,) = names["verify.final_check"]
    (dev,) = names["msm.device"]
    (dedup,) = names["msm.dedup"]
    assert dev.parent == final.id and dedup.parent == final.id
    assert totals["msm.device.terms"] == dev.attrs["terms"] > 0
    kids = {r.name for r in recs if r.parent == dev.id}
    assert kids == {"msm.bases", "msm.scalars", "msm.upload", "msm.enqueue",
                    "msm.wait", "msm.horner"}
    # the merge loop's bound read waits on the card inside the enqueue
    waits = names["msm.wait"]
    assert len(waits) == 2
    assert {ids[w.parent].name for w in waits} == {"msm.device",
                                                   "msm.enqueue"}


def test_cache_hits_are_counted(blocks, monkeypatch):
    monkeypatch.delenv("CP_NO_DECOMPRESS_CACHE", raising=False)
    _, shuffles = blocks
    pre = shuffles[0][0]
    bufs = [t.r_G for t in pre] + [t.k_r_G for t in pre]
    serde.g1_from_bytes_batch(bufs)           # fills the cache
    trace.enable()
    serde.g1_from_bytes_batch(bufs)
    serde.g1_from_bytes(bufs[0])
    assert trace.counters()["g1.decompress_cache_hits"] == len(bufs) + 1


def test_batch_prove_dispatch_spans_match_last_timings():
    from test_torch_batch_prove import batched

    trace.enable()
    batched(ELL, 2)
    lt = dict(bp.batch_prove.last_timings)
    assert set(lt) == {"table_s", "bases_s", "pack_s", "device_s",
                       "decode_s", "dispatches", "wave_s", "host_other_s"}
    assert lt["host_other_s"] == pytest.approx(lt["wave_s"] - sum(
        lt[k] for k in ("bases_s", "pack_s", "device_s", "decode_s")))
    names = _by_name(trace.records())
    for span_name, key in (("dispatch.pack", "pack_s"),
                           ("dispatch.device", "device_s"),
                           ("dispatch.decode", "decode_s"),
                           ("prove.bases", "bases_s"),
                           ("prove.table", "table_s"),
                           ("prove.wave", "wave_s")):
        total = sum(r.t1_ns - r.t0_ns for r in names[span_name]) * 1e-9
        assert total == pytest.approx(lt[key], rel=0.01), span_name
    (wave,) = names["prove.wave"]
    steps = [r.name for r in sorted(trace.records(), key=lambda r: r.t0_ns)
             if r.parent == wave.id]
    assert steps == ["prove.bases", "prove.setup", "prove.ipa_rounds",
                     "prove.same_scalar", "prove.msm_rounds",
                     "prove.assemble"]
    assert lt["dispatches"] == len(names["prove.dispatch"]) \
        == len(names["dispatch.wait"])
    assert trace.attr_totals(trace.records())["prove.dispatch.relations"] \
        == sum(r.attrs["relations"] for r in names["prove.dispatch"]) > 0
