"""The kernel store: built CUDA kernel libraries, keyed by their content.

The JAX package's `ops/aot.py` removes the TPU's per-process lowering by
storing exported pipelines under a hash of their sources.  The port's cold
cost is another one: nvcc builds the eight kernel libraries (one shared
object a `csrc/*.cu` source) at their first use.  So the port stores those
libraries, and a process that finds them loads them with no nvcc on the
machine.

The store is a directory, `aot_dir()`: `CURDLEPROOFS_AOT_DIR`, by default
`curdleproofs_aot` in the temporary directory, outside the tree, as the
reference's `/tmp/curdleproofs_aot`.  `CURDLEPROOFS_AOT=0` keeps the
libraries in the tree's gitignored `_build/cuda/`, under the same key.
Artifacts lie in `<store>/cuda_s<schema>_<code hash>/`:

    lib<source>.so     the library nvcc built
    lib<source>.json   its record: the key, the toolkit that built it, the
                       library's sha256 and size, nvcc's seconds and its
                       ptxas report (registers, spills)
    sqrt_constants.h   the generated header the sources include
    build.lock         held while a process builds

The key.  `_code_hash()` hashes every `csrc/*.cu` and `*.cuh`, the text of
the generated headers, `NVCC_FLAGS` and the schema number: a change to any
of them names another directory, so a stale library is never found.  The
kernels take any shape, so there is one artifact a source, not one a shape
family as in the reference.  The toolkit's identity (`nvcc --version`)
completes each artifact's key (`_key`), and is stored in its record: a
load checks the record against itself and the library against its sha256,
and reads no toolkit, so a hit needs no nvcc and never runs it.  The
toolkit is read when building (`export`), and an artifact built by another
toolkit is then built again.

A miss builds: under the store's lock, every missing source at once, one
nvcc a source, each into a temporary file renamed into place, then its
record.  A record or library that does not verify (stale, torn or corrupt)
is a miss and is built again; nothing is skipped, and nothing falls back to
a plain version.  A build that fails, or a miss with no nvcc, raises.
"""

from __future__ import annotations

import fcntl
import functools
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "SOURCES", "aot_dir", "enabled",
           "export", "load", "maybe_load", "store_dir", "stored",
           "toolkit_identity"]

_SCHEMA = 1  # bump to invalidate every stored library

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parent / "_build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# one shared object a source
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

# in-memory cache: library path -> its verified record
_LOADED: dict[str, dict] = {}
_LOCK = threading.Lock()   # a stream's worker and the warm-up thread load too


def aot_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "CURDLEPROOFS_AOT_DIR",
        pathlib.Path(tempfile.gettempdir()) / "curdleproofs_aot"))


def enabled() -> bool:
    """The store is on by default; CURDLEPROOFS_AOT=0 keeps the libraries
    in the tree's `_build/cuda/`."""
    return os.environ.get("CURDLEPROOFS_AOT", "1") != "0"


def _generated() -> dict[str, str]:
    """The headers the build generates beside the sources."""
    from .kernels import constants_text   # kernels loads this module lazily

    return {"sqrt_constants.h": constants_text()}


def _code_hash() -> str:
    """Hash of the sources, the generated headers, the flags and the
    schema (not the toolkit: see `_key`)."""
    h = hashlib.sha256(f"schema {_SCHEMA}\n".encode())
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(f"\0{p.name}\0".encode())
        h.update(p.read_bytes())
    for name, text in sorted(_generated().items()):
        h.update(f"\0{name}\0".encode())
        h.update(text.encode())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _key(toolkit: str, code: str | None = None) -> str:
    """An artifact's full key: the code hash and the toolkit that built it."""
    code = code or _code_hash()
    return hashlib.sha256(f"{code}\0{toolkit}".encode()).hexdigest()[:16]


def store_dir() -> pathlib.Path:
    """Where this tree's libraries lie: in the store, or in `_build/cuda/`
    with CURDLEPROOFS_AOT=0, under the code hash."""
    root = aot_dir() if enabled() else BUILD_DIR
    return root / f"cuda_s{_SCHEMA}_{_code_hash()}"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use, and the kernel store "
                       f"({store_dir()}) does not hold them")


@functools.cache
def toolkit_identity(nvcc: str) -> str:
    """`nvcc --version`, as the toolkit's identity (read once a process, and
    only when building)."""
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip()


def _verify(d: pathlib.Path, source: str, code: str) -> dict | None:
    """The record of `source`'s library in `d` if both verify: the record
    names this source, schema and code hash under its own toolkit, and the
    library's bytes hash to the record's sha256.  Else None."""
    so = d / f"lib{source}.so"
    try:
        rec = json.loads((d / f"lib{source}.json").read_text())
        data = so.read_bytes()
    except (OSError, ValueError):
        return None
    if not isinstance(rec, dict) or rec.get("schema") != _SCHEMA \
            or rec.get("source") != source or rec.get("code") != code \
            or rec.get("key") != _key(str(rec.get("toolkit")), code) \
            or rec.get("sha256") != hashlib.sha256(data).hexdigest():
        return None
    return {**rec, "path": str(so)}


def _write_atomic(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    tmp.replace(path)


def maybe_load(source: str) -> dict | None:
    """The verified record of `source`'s stored library (its `path`, `key`,
    `toolkit`, `ptxas`, `build_s`; `built`: whether this process built it),
    or None on a miss.  Runs no compiler."""
    d = store_dir()
    so = str(d / f"lib{source}.so")
    with _LOCK:
        rec = _LOADED.get(so)
        if rec is None:
            rec = _verify(d, source, _code_hash())
            if rec is not None:
                rec["built"] = False
                _LOADED[so] = rec
    return rec


def load(source: str) -> dict:
    """`maybe_load`, and on a miss `export()` of every source (the missing
    ones build together); raises if the build fails."""
    rec = maybe_load(source)
    if rec is None:
        rec = export()[source]
    return rec


def export(log=None) -> dict[str, dict]:
    """Build into the store each source that is missing, does not verify,
    or was built by another toolkit than this machine's, one nvcc a source,
    all started together; return every source's record.  `log(line)`, when
    given, hears of each."""
    code = _code_hash()
    d = store_dir()
    d.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    toolkit = toolkit_identity(nvcc)
    key = _key(toolkit, code)
    recs: dict[str, dict] = {}
    with _LOCK, open(d / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = []
        for s in SOURCES:
            rec = _verify(d, s, code)
            if rec is not None and rec["toolkit"] == toolkit:
                recs[s] = {**rec, "built": False}
            else:
                todo.append(s)
        for name, text in _generated().items():
            _write_atomic(d / name, text)
        procs = {}
        t0 = time.perf_counter()
        for s in todo:
            tmp = d / f"lib{s}.so.{os.getpid()}.tmp"
            out = tempfile.TemporaryFile("w+")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(d), "-o", str(tmp),
                   str(CSRC / f"{s}.cu")]
            procs[s] = (tmp, out, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, text=True))
        done: dict[str, float] = {}
        try:
            while len(done) < len(procs):
                for s, (_, _, p) in procs.items():
                    if s not in done and p.poll() is not None:
                        done[s] = time.perf_counter() - t0
                time.sleep(0.02)
        finally:
            for _, _, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = []
        for s, (tmp, out, p) in procs.items():
            out.seek(0)
            report = out.read()
            out.close()
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"--- {s} ---\n{report}")
                continue
            data = tmp.read_bytes()
            rec = {"schema": _SCHEMA, "source": s, "code": code, "key": key,
                   "toolkit": toolkit, "flags": NVCC_FLAGS,
                   "sha256": hashlib.sha256(data).hexdigest(),
                   "bytes": len(data), "build_s": done[s], "ptxas": report}
            tmp.replace(d / f"lib{s}.so")
            _write_atomic(d / f"lib{s}.json", json.dumps(rec, indent=1))
            recs[s] = {**rec, "path": str(d / f"lib{s}.so"), "built": True}
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for rec in recs.values():
            _LOADED[rec["path"]] = rec
    if log:
        for s in SOURCES:
            r = recs[s]
            log(f"{s}: {'built' if r['built'] else 'stored'}, "
                f"{r['bytes']} bytes, nvcc {r['build_s']:.1f} s, key {r['key']}")
    return recs


def stored() -> list[str]:
    """The sources whose libraries the store holds for this tree."""
    return [s for s in SOURCES if maybe_load(s) is not None]
