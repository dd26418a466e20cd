"""Background device warm-up: overlap the card's start-up with host work.

A cold process pays a serial chain before its first device result: CUDA's
initialisation (the context), the kernel libraries' load (from the kernel
store, `aot.py`, or their build), each kernel's own load at its first
launch (CUDA loads a module's kernels lazily), the bases' upload, the first
pipeline.  Everything before the upload needs no protocol data, so a
process that knows it will touch the card can start it on a daemon thread
early and spend the wait on host work (CRS, witnesses, base export).

`start_background_init()` is idempotent and cheap to call early;
`wait_ready()` joins it and returns what it recorded: `init_s` (CUDA
initialised and a first computation read back), `total_s` (the kernels
loaded and launched once each, when asked), `launches` (those launches,
counted apart from `kernels.LAUNCHES`, so no counted path sees them), or
`error`.  Without a card the error is recorded, and the caller's own first
device touch raises as it would have: nothing falls back.
`tools/cold_start_probe.py` measures it under CURDLEPROOFS_BG_INIT=1.
"""

from __future__ import annotations

import threading
import time
import traceback

__all__ = ["start_background_init", "wait_ready"]

_lock = threading.Lock()
_thread: threading.Thread | None = None
_result: dict = {}


def _init_worker(load_aot_families: bool) -> None:
    t0 = time.perf_counter()
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        torch.cuda.init()
        # the context and the first computation read back: the card's
        # share of a process's first device touch
        (torch.zeros(8, dtype=torch.int32, device="cuda") + 1).cpu()
        _result["init_s"] = time.perf_counter() - t0
        if load_aot_families:
            from . import kernels

            with kernels.launches_into({}) as launches:
                kernels.warm_entries("cuda")
            torch.cuda.synchronize()
            _result["launches"] = launches
        _result["total_s"] = time.perf_counter() - t0
    except Exception as e:  # the thread's boundary: record, never fall back
        _result["error"] = repr(e)[:200]
        _result["traceback"] = traceback.format_exc()[-2000:]


def start_background_init(load_aot_families: bool = True) -> None:
    """Begin device init on a daemon thread (idempotent).  With
    `load_aot_families`, also load every kernel library and launch each
    of its kernels once."""
    global _thread
    with _lock:
        if _thread is None:
            _thread = threading.Thread(
                target=_init_worker, args=(load_aot_families,), daemon=True)
            _thread.start()


def wait_ready(timeout: float | None = None) -> dict:
    """Join the background init; returns its timing/err dict."""
    t = _thread
    if t is not None:
        t.join(timeout)
    return dict(_result)
