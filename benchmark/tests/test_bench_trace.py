"""The trace's reduction: the harness's own probe operations stay out of
the device's busy time and of the operations' seconds."""

import json

from harness.trace import read_trace


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_probe_operations_are_left_out(tmp_path):
    events = [
        _ev("bench/window", "user_annotation", 0, 1000),
        _ev("bench/batch", "user_annotation", 10, 900),
        _ev("cudaLaunchKernel", "cuda_runtime", 20, 2, corr=1),
        _ev("g1_fold_kernel", "kernel", 30, 100, corr=1),
        _ev("bench/probe", "user_annotation", 140, 20),
        _ev("cudaLaunchKernel", "cuda_runtime", 145, 2, corr=2),
        _ev("reduce_kernel", "kernel", 150, 300, corr=2),
        _ev("cudaMemcpyAsync", "cuda_runtime", 500, 2, corr=3),
        _ev("Memcpy HtoD", "gpu_memcpy", 510, 40, corr=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_trace(path)
    assert abs(t.busy_s - 140e-6) < 1e-12
    assert abs(t.window_s - 1000e-6) < 1e-12
    assert set(t.op_seconds) == {"g1_fold_kernel", "Memcpy HtoD"}
    assert [g[0] for g in t.gaps] == ["batch"] * 3
