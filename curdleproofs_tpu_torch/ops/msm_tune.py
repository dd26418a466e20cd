"""Measured MSM engine parameters and routing crossovers (the JAX package's
`ops/msm_tune.py`).

A tune table is JSON keyed by the device type an MSM runs on (`"cuda"` or
`"cpu"`), then by padded shape family n; each entry holds the measured
`device_warm_ms`, `fresh_prep_ms` (with `fresh_prep_host_ms` and
`ingest_dev_ms`), `host_ms`, the window width `c` and its params echo.
`tools/msm_autotune.py` measures a family and writes it through
`record_entry`; `pick_params` reads its `c` (`tuned_c`), `HybridBackend`
its device-vs-host crossover (`route_to_device`) and batch verification its
split (`parallel/batch_verify.py::plan_split_fraction`), each the entry of
the device it runs on, so a `"tpu"` or `"cpu"` entry never routes work on
the card.  `CURDLEPROOFS_TUNE` names the file; else it is `msm_tune.json`
beside this module, the table the port ships: `"cuda"` entries for the
families 2^7-2^10, 2^12, ..., 2^20, made on an H100 by two passes of
`tools/msm_autotune.py` (every device result equal to the native host
MSM's), with a top-level `"stamp"` (the card's nvidia-smi line, the
commit, the sources' sha256, torch's version, the date) that no reader
takes for a device type.  It holds no `"cpu"` entry, so a CPU run reads an
empty table and stays untuned, as does a `CURDLEPROOFS_TUNE` naming an
absent file.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib

import torch

__all__ = ["HOST_MS_GUARD", "STAMP_KEY", "load_table", "record_entry",
           "record_stamp", "route_to_device", "table_path", "table_stamp",
           "tuned_c"]

#: The table's one top-level key that is not a device type.
STAMP_KEY = "stamp"


def table_path() -> pathlib.Path:
    env = os.environ.get("CURDLEPROOFS_TUNE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).parent / "msm_tune.json"


def _platform(device="cuda") -> str:
    """The table key of `device`: its type."""
    return torch.device(device).type


@functools.cache
def _load_raw() -> dict:
    p = table_path()
    if not p.is_file():
        return {}
    try:
        return json.loads(p.read_text())
    except (OSError, ValueError):
        return {}


def load_table(device="cuda") -> dict:
    """{n_pad(int): entry} for `device`'s type; {} when untuned."""
    raw = _load_raw().get(_platform(device), {})
    return {int(k): v for k, v in raw.items()}


def table_stamp() -> dict | None:
    """The table's `STAMP_KEY` entry (what made it), or None."""
    return _load_raw().get(STAMP_KEY)


def tuned_c(n_pad: int, device="cuda") -> int | None:
    """Measured window width for this exact family, or None if untuned."""
    e = load_table(device).get(n_pad)
    return None if e is None else int(e["c"])


def _nearest(table: dict, n: int):
    if not table:
        return None
    key = min(table, key=lambda k: abs(k.bit_length() - n.bit_length())
              * (1 << 20) + abs(k - n))
    return key, table[key]


def route_to_device(n: int, resident: bool, device="cuda") -> bool | None:
    """Measured routing verdict for an n-point MSM on `device`, or None if
    untuned.

    Scales the nearest measured family's device/host walls linearly with n
    (both engines are ~linear in n within an octave) and compares:
        resident bases:  device_warm  vs  host
        fresh bases:     device_warm + fresh_prep  vs  host
    """
    hit = _nearest(load_table(device), n)
    if hit is None:
        return None
    key, e = hit
    scale = n / key
    dev = e["device_warm_ms"] * scale
    if not resident:
        dev += e["fresh_prep_ms"] * scale
    return dev < e["host_ms"] * scale


#: Contention guard: a pass whose host wall disagrees with the recorded
#: entry by more than this factor (either direction) is quarantined, not
#: written live: one contended pass must not rewrite the routing model.
HOST_MS_GUARD = 1.5


def _agrees(a: float, b: float, factor: float = HOST_MS_GUARD) -> bool:
    if a <= 0 or b <= 0:
        return True
    r = a / b
    return 1.0 / factor <= r <= factor


def record_entry(n_pad: int, entry: dict, force: bool = False,
                 device="cuda") -> str:
    """Persist one family's measurements on `device` (tools/msm_autotune.py)
    under its device type.

    Returns "written" or "quarantined".  A pass whose `host_ms` deviates
    >HOST_MS_GUARD x from the recorded entry is stored under the entry's
    "pending" field instead of replacing it; a SECOND pass agreeing with the
    pending one (within the same factor) then overwrites: one contended
    pass can never corrupt the routing model alone.  `force=True` bypasses
    the guard (explicit operator intent).  Accepted passes append to a
    bounded `host_ms_history` so drift stays visible.
    """
    raw = _read_for_update()
    fam = raw.setdefault(_platform(device), {})
    prev = fam.get(str(n_pad))
    status = "written"
    if (prev is not None and not force
            and not _agrees(entry["host_ms"], prev["host_ms"])):
        pending = prev.get("pending")
        if pending is not None and _agrees(entry["host_ms"],
                                           pending["host_ms"]):
            # two consecutive agreeing passes: the platform really moved
            entry = dict(entry)
            entry["host_ms_history"] = (
                prev.get("host_ms_history", [prev["host_ms"]])
                + [pending["host_ms"], entry["host_ms"]])[-6:]
            fam[str(n_pad)] = entry
        else:
            prev = dict(prev)
            prev["pending"] = {k: entry[k] for k in
                               ("host_ms", "device_warm_ms", "c")}
            fam[str(n_pad)] = prev
            status = "quarantined"
    else:
        entry = dict(entry)
        hist = [] if prev is None else prev.get("host_ms_history",
                                                [prev["host_ms"]])
        entry["host_ms_history"] = (hist + [entry["host_ms"]])[-6:]
        fam[str(n_pad)] = entry
    _write(raw)
    return status


def record_stamp(stamp: dict) -> None:
    """Set the table's `STAMP_KEY` entry (what made it: tools/msm_autotune.py
    writes the card, the commit, the sources' hash, torch's version and the
    date after each pass); every device type's entries stay as they are."""
    raw = _read_for_update()
    raw[STAMP_KEY] = stamp
    _write(raw)


def _read_for_update() -> dict:
    p = table_path()
    if p.is_file():
        try:
            return json.loads(p.read_text())
        except (OSError, ValueError):
            pass
    return {}


def _write(raw: dict) -> None:
    p = table_path()
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(raw, indent=1, sort_keys=True) + "\n")
    tmp.replace(p)
    _load_raw.cache_clear()
