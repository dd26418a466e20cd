"""The readers of the program's own spans (`benchmark/metrics/`:
`decompress_us_per_point.verify`, `final_msm_host_ms.verify`,
`device_wait_pct.prove`, `witness_setup_pct.prove`,
`witness_rounds_pct.prove`): each gives its number from synthetic records,
leaves out the harness's probe time and the records outside the window,
and gives None without records; a traced run of each entry at the tiny
size reports them, and recording the program's spans moves neither the
other metrics' presence nor the trace's reduction."""

import json
import pathlib
import types

import pytest

from conftest import BENCH, run_cpu
from harness.core import load_module
from harness.trace import read_trace

from curdleproofs_tpu_torch.utils import trace

SEED = 3_000_000_101
NEW = {"tiny_l4.sync": {"decompress_us_per_point.verify",
                        "final_msm_host_ms.verify"},
       "tiny_l4.relay": {"device_wait_pct.prove", "witness_setup_pct.prove",
                         "witness_rounds_pct.prove"}}
FORCED_OFF = ("import curdleproofs_tpu_torch.utils.trace as _t\n"
              "_t._profiler_check = lambda: _t._no_profiler\n")


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"reader_{name}")


def _run(spans):
    """What a reader reads of a run: the harness's (name, start, end)."""
    return types.SimpleNamespace(spans=types.SimpleNamespace(records=spans))


def _records(spans):
    """Program records from (id, parent, name, start s, end s, attrs)."""
    return [trace.Record(i, p, 1, n, round(a * 1e9), round(b * 1e9), 1, at)
            for i, p, n, a, b, at in spans]


# the window is [10, 20] s; a probe of 0.5 s sits in the first final
# check's device MSM and in the first wave's first dispatch
HARNESS = [("window", 10.0, 20.0), ("probe", 12.2, 12.7),
           ("probe", 16.2, 16.7)]

SYNC = _records([
    (1, None, "whisk.unzip_trackers", 9.0, 9.5, {"points": 8}),   # outside
    (2, None, "whisk.unzip_trackers", 10.0, 10.4, {"points": 8}),
    (3, None, "whisk.unzip_trackers", 10.5, 11.1, {"points": 8}),
    (4, None, "verify.final_check", 12.0, 14.0, None),
    (5, 4, "msm.device", 12.1, 13.9, None),
    (6, 5, "msm.wait", 13.0, 13.2, None),
    (7, 5, "msm.wait", 13.4, 13.5, None),
    (8, None, "verify.final_check", 15.0, 15.5, None),
    (9, 8, "msm.device", 15.1, 15.4, None),
    (10, 9, "msm.wait", 15.2, 15.3, None),
    (11, None, "verify.final_check", 19.5, 20.5, None),            # cut off
    (12, 11, "msm.device", 19.6, 20.4, None),
])

PROVE = _records([
    (1, None, "prove.wave", 8.0, 9.9, None),                         # outside
    (2, 1, "prove.setup", 8.1, 9.0, None),
    (3, None, "prove.wave", 14.0, 18.0, None),
    (4, 3, "prove.setup", 14.0, 15.0, None),
    (5, 4, "prove.dispatch", 14.2, 14.5, None),
    (6, 5, "dispatch.wait", 14.3, 14.4, None),
    (7, 3, "prove.ipa_rounds", 15.0, 16.0, None),
    (8, 7, "prove.dispatch", 15.5, 15.9, None),
    (9, 8, "dispatch.wait", 15.6, 15.7, None),
    (10, 3, "prove.msm_rounds", 16.0, 17.5, None),
    (11, 10, "prove.dispatch", 16.1, 16.9, None),    # holds the 0.5 s probe
    (12, 11, "dispatch.wait", 16.8, 16.85, None),
    (13, 3, "prove.same_scalar", 17.5, 17.6, None),
])

# wave 4.0 s less the 0.5 s probe inside it
WANT = {"decompress_us_per_point.verify": (SYNC, 1.0 / 16 * 1e6),
        "final_msm_host_ms.verify": (SYNC, ((1.8 - 0.5 - 0.3) + (0.3 - 0.1))
                                     / 2 * 1e3),
        "device_wait_pct.prove": (PROVE, 100 * 0.25 / 3.5),
        "witness_setup_pct.prove": (PROVE, 100 * 0.7 / 3.5),
        "witness_rounds_pct.prove": (PROVE, 100 * (0.6 + 0.7) / 3.5)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_synthetic_records(monkeypatch, name):
    recs, want = WANT[name]
    read = _reader(name).read
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    assert read(_run(HARNESS)) == pytest.approx(want, rel=1e-6)
    # the other entry's records hold none of its spans
    other = PROVE if recs is SYNC else SYNC
    monkeypatch.setattr(trace, "records", lambda: list(other))
    assert read(_run(HARNESS)) is None
    monkeypatch.setattr(trace, "records", lambda: [])
    assert read(_run(HARNESS)) is None
    # a program without the recorder (the parent's) gives None, no error
    monkeypatch.delattr(trace, "records")
    assert read(_run(HARNESS)) is None


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """A traced run of each tiny cell, with the program's recording as it
    is and forced off."""
    from conftest import add_tiny, copy_benchmark

    root = copy_benchmark(tmp_path_factory.mktemp("spans"))
    add_tiny(root)
    out = {}
    for cell, seconds in (("tiny_l4.sync", 1), ("tiny_l4.relay", 1)):
        for how, prelude in (("on", ""), ("off", FORCED_OFF)):
            rc, res, err = run_cpu(root, "--workload", cell, "--seed",
                                   str(SEED), "--seconds", str(seconds),
                                   "--trace", "1", prelude=prelude)
            assert rc == 0 and res is not None, err[-3000:]
            out[cell, how] = res
    return out


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reports_the_program_spans(traced_runs, cell):
    on, off = traced_runs[cell, "on"], traced_runs[cell, "off"]
    for name in NEW[cell]:
        assert isinstance(on["metrics"][name]["value"], float), name
    assert not NEW[cell] & set(off["metrics"])
    # the other metrics are the same with the program's spans recorded
    assert set(on["metrics"]) - NEW[cell] == set(off["metrics"])
    assert ("breakdown" in on) == ("breakdown" in off)
    assert on["device"]["platform"] == off["device"]["platform"] == "cpu"


def test_program_ranges_leave_the_trace_reduction_as_it_was(tmp_path):
    """The harness's reduction reads `bench/` ranges only: the program's
    `cp/` ranges on the same timeline change neither the busy time nor the
    operations nor the names of the idle gaps."""
    def ev(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    base = [ev("bench/window", "user_annotation", 0, 1000),
            ev("bench/wave", "user_annotation", 10, 900),
            ev("bench/dispatch", "user_annotation", 100, 200),
            ev("cudaLaunchKernel", "cuda_runtime", 120, 2, corr=1),
            ev("g1_fold_kernel", "kernel", 130, 100, corr=1),
            ev("Memcpy DtoH", "gpu_memcpy", 280, 10, corr=2)]
    ranges = [ev("cp/prove.wave", "user_annotation", 11, 898),
              ev("cp/prove.setup", "user_annotation", 12, 400),
              ev("cp/prove.dispatch", "user_annotation", 101, 198),
              ev("cp/dispatch.wait", "user_annotation", 240, 55)]
    got = []
    for events in (base, base + ranges):
        path = tmp_path / f"t{len(got)}.json"
        path.write_text(json.dumps({"traceEvents": events}))
        got.append(read_trace(pathlib.Path(path)))
    assert got[0] == got[1]
    assert [g[0] for g in got[1].gaps] == ["wave", "wave", "dispatch"]
