"""Downgrade-guarded benchmark-artifact writer (a copy of the JAX
package's `utils/artifacts.py`).

A smoke-scale refresh once replaced a larger multi-host measurement
(`bench_multihost.json`, B=1024/ell=252) with a B=4/ell=28 run, and the
larger result survived only in git history.  A refresh may only replace an
artifact with one of equal-or-larger scale and equal-or-richer schema,
unless the operator explicitly opts into the downgrade.
"""

from __future__ import annotations

import json
import os
import pathlib

__all__ = ["ArtifactDowngrade", "write_artifact"]

#: Env var that authorises a scale/schema downgrade (explicit operator intent).
DOWNGRADE_ENV = "CURDLEPROOFS_ARTIFACT_DOWNGRADE"


class ArtifactDowngrade(RuntimeError):
    """Refusing to replace an artifact with a smaller/poorer one."""


def _downgrades(old: dict, new: dict, rank_keys: tuple[str, ...]) -> list[str]:
    found = []
    for k in rank_keys:
        if k in old and isinstance(old[k], (int, float)):
            if k not in new:
                found.append(f"rank key {k!r} dropped (was {old[k]})")
            elif isinstance(new[k], (int, float)) and new[k] < old[k]:
                found.append(f"{k}: {old[k]} -> {new[k]}")
    missing = [k for k in old if k not in new]
    if missing:
        found.append(f"schema keys dropped: {sorted(missing)}")
    return found


def write_artifact(path: str | pathlib.Path, data: dict,
                   rank_keys: tuple[str, ...] = ("world", "batch", "ell"),
                   allow_downgrade: bool = False) -> None:
    """Atomically write a JSON artifact, refusing scale/schema downgrades.

    If `path` already holds parseable JSON, the new `data` must not shrink
    any numeric `rank_keys` value nor drop any top-level key the old
    artifact had; otherwise ArtifactDowngrade is raised.  Pass
    `allow_downgrade=True` or set CURDLEPROOFS_ARTIFACT_DOWNGRADE=1 to
    replace anyway (e.g. an intentional smoke-scale re-baseline).
    """
    path = pathlib.Path(path)
    allow = allow_downgrade or os.environ.get(DOWNGRADE_ENV) == "1"
    if path.is_file() and not allow:
        try:
            old = json.loads(path.read_text())
        except (OSError, ValueError):
            old = None
        if isinstance(old, dict):
            bad = _downgrades(old, data, rank_keys)
            if bad:
                raise ArtifactDowngrade(
                    f"refusing to overwrite {path.name}: {'; '.join(bad)} "
                    f"(set {DOWNGRADE_ENV}=1 to force)")
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(data, indent=1) + "\n")
    tmp.replace(path)
