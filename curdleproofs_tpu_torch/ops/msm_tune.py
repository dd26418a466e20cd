"""Measured MSM engine parameters: the table reader.

A tune table is JSON keyed by the device type an MSM runs on (`"cuda"` or
`"cpu"`), then by padded shape family n; each entry holds the measured
`device_warm_ms`, `fresh_prep_ms` (with optional `fresh_prep_host_ms` and
`ingest_dev_ms`), `host_ms` and the window width `c` (the JAX package's
`ops/msm_tune.py` format).  `CURDLEPROOFS_TUNE` names the file; else it is
`msm_tune.json` beside this module.  The port ships no table: the JAX
package's was measured on a TPU and must not route work on the card, and
the autotuner that would fill a `"cuda"` table is still to be ported.
Untuned, every reader sees an empty table.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib

import torch

__all__ = ["load_table", "table_path"]


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
