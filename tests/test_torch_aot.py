"""The kernel store (curdleproofs_tpu_torch.ops.aot): its key, its
environment, and its export and load, with a fake compiler standing in for
nvcc, so that they run where no CUDA toolkit is installed.

The fake (`bin/nvcc` under a temporary CUDA_HOME) answers `--version` with
the text of a file the test can change, writes a library whose bytes name
its source and that source's sha256, prints a ptxas-like report, and logs
every call, so a test counts the builds and the toolkit reads."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import textwrap

import pytest
import torch

from curdleproofs_tpu.ops import aot as ref_aot
from curdleproofs_tpu_torch.ops import aot
from curdleproofs_tpu_torch.ops import kernels as K

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

_REPO = pathlib.Path(__file__).resolve().parents[1]

_FAKE = textwrap.dedent("""\
    #!{python}
    import hashlib, os, pathlib, sys, time
    here = pathlib.Path(__file__).resolve().parents[1]
    args = sys.argv[1:]
    with open(here / "calls.log", "a") as log:
        log.write(("--version" if "--version" in args else
                   pathlib.Path(args[-1]).stem) + "\\n")
    if "--version" in args:
        print((here / "version.txt").read_text())
        sys.exit(0)
    time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "0")))
    src = pathlib.Path(args[-1])
    if os.environ.get("FAKE_NVCC_FAIL") == src.stem:
        print(f"{{src}}(1): error: fake failure")
        sys.exit(2)
    out = pathlib.Path(args[args.index("-o") + 1])
    inc = pathlib.Path(args[args.index("-I") + 1])
    assert (inc / "sqrt_constants.h").is_file()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    out.write_text(f"fake library of {{src.stem}} {{digest}}\\n")
    print(f"ptxas info    : Compiling entry function '{{src.stem}}_kernel'")
    print("ptxas info    : Used 42 registers")
    """)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A fake toolkit under CUDA_HOME and an empty store; returns its
    directory (calls.log, version.txt)."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE.format(python=sys.executable))
    nvcc.chmod(0o755)
    (home / "version.txt").write_text("fake nvcc, release 1.0")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("CURDLEPROOFS_AOT_DIR", str(tmp_path / "store"))
    monkeypatch.delenv("CURDLEPROOFS_AOT", raising=False)
    monkeypatch.setattr(aot, "_LOADED", {})
    aot.toolkit_identity.cache_clear()
    yield home
    aot.toolkit_identity.cache_clear()


def _calls(home: pathlib.Path) -> list[str]:
    log = home / "calls.log"
    return log.read_text().split() if log.exists() else []


def _no_nvcc(tmp_path, monkeypatch):
    """No compiler anywhere the store looks (CUDA_HOME, PATH)."""
    empty = tmp_path / "no_cuda"
    empty.mkdir(exist_ok=True)
    monkeypatch.setenv("CUDA_HOME", str(empty))
    monkeypatch.setenv("PATH", str(empty))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a toolkit is installed where the store always looks")


# --------------------------------------------------------------------------
# the key
# --------------------------------------------------------------------------

def test_key_follows_every_build_input(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(aot.CSRC, csrc)
    monkeypatch.setattr(aot, "CSRC", csrc)
    base = aot._code_hash()
    assert aot._code_hash() == base                 # deterministic

    # an unrelated file, in csrc and in the package, changes nothing
    (csrc / "NOTES.txt").write_text("not a build input")
    (tmp_path / "unrelated.py").write_text("x = 1\n")
    assert aot._code_hash() == base

    for name in ("fq_mul.cu", "fq_cc.cuh"):          # any csrc byte
        f = csrc / name
        orig = f.read_bytes()
        f.write_bytes(orig[:-1] + bytes([orig[-1] ^ 1]))
        assert aot._code_hash() != base, name
        f.write_bytes(orig)
        assert aot._code_hash() == base

    new_cuh = csrc / "extra.cuh"                    # a new header counts
    new_cuh.write_text("// more\n")
    assert aot._code_hash() != base
    new_cuh.unlink()

    text = K.constants_text()                       # the generated header
    monkeypatch.setattr(K, "constants_text", lambda: text + "// changed\n")
    assert aot._code_hash() != base
    monkeypatch.setattr(K, "constants_text", lambda: text)
    assert aot._code_hash() == base

    monkeypatch.setattr(aot, "NVCC_FLAGS", [*aot.NVCC_FLAGS, "-lineinfo"])
    assert aot._code_hash() != base
    monkeypatch.undo()

    # the toolkit completes the key; the store's directory is the code hash
    code = aot._code_hash()
    assert aot._key("release 12.4", code) != aot._key("release 12.8", code)
    assert aot._key("release 12.4", code) == aot._key("release 12.4", code)
    assert aot.store_dir().name == f"cuda_s{aot._SCHEMA}_{code}"


def test_sources_are_the_kernels_sources():
    assert sorted(aot.SOURCES) == sorted(K.ENTRIES) == sorted(
        k for k in K.KERNELS if K.source_of(k) == k)
    assert K.CSRC == aot.CSRC
    # every C entry the wrappers bind belongs to one source
    entries = [e for es in K.ENTRIES.values() for e in es]
    assert sorted(entries) == sorted(K._ARGTYPES)


# --------------------------------------------------------------------------
# the environment, against the reference's jax-free functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("env", [
    {}, {"CURDLEPROOFS_AOT": "0"}, {"CURDLEPROOFS_AOT": "1"},
    {"CURDLEPROOFS_AOT": "no"}, {"CURDLEPROOFS_AOT_DIR": "/srv/aot"},
    {"CURDLEPROOFS_AOT": "0", "CURDLEPROOFS_AOT_DIR": "relative/aot"},
])
def test_environment_as_the_reference_reads_it(env, monkeypatch):
    for k in ("CURDLEPROOFS_AOT", "CURDLEPROOFS_AOT_DIR", "TMPDIR", "TEMP",
              "TMP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # the default lies in the temporary directory: /tmp with TMPDIR unset,
    # as in the reference
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert aot.enabled() == ref_aot.enabled()
    assert aot.aot_dir() == ref_aot.aot_dir()
    if not aot.enabled():   # the libraries stay in the tree, same key
        assert aot.store_dir() == aot.BUILD_DIR / aot.store_dir().name


# --------------------------------------------------------------------------
# export and load
# --------------------------------------------------------------------------

def test_miss_builds_once_then_hits(fake_nvcc):
    recs = aot.export()
    assert sorted(recs) == sorted(aot.SOURCES)
    assert all(r["built"] for r in recs.values())
    assert sorted(_calls(fake_nvcc)) == sorted(["--version", *aot.SOURCES])
    d = aot.store_dir()
    for s, r in recs.items():
        data = (d / f"lib{s}.so").read_bytes()
        digest = hashlib.sha256((aot.CSRC / f"{s}.cu").read_bytes())
        assert data.decode() == f"fake library of {s} {digest.hexdigest()}\n"
        assert r["sha256"] == hashlib.sha256(data).hexdigest()
        assert r["toolkit"] == "fake nvcc, release 1.0"
        assert "Used 42 registers" in r["ptxas"]
        assert json.loads((d / f"lib{s}.json").read_text())["key"] == r["key"]
    assert (d / "sqrt_constants.h").read_text() == K.constants_text()

    # again: everything stored, nothing built
    again = aot.export()
    assert not any(r["built"] for r in again.values())
    assert len(_calls(fake_nvcc)) == 1 + len(aot.SOURCES)  # read once

    # a fresh process's view: hits carry the stored ptxas report
    aot._LOADED.clear()
    rec = aot.maybe_load("fq_mul")
    assert rec is not None and not rec["built"]
    assert rec["path"] == str(d / "libfq_mul.so")
    assert "Used 42 registers" in rec["ptxas"]
    assert aot.export()["g1_sqrt"]["ptxas"] == recs["g1_sqrt"]["ptxas"]


def test_a_hit_needs_no_compiler(fake_nvcc, tmp_path, monkeypatch):
    aot.export()
    n_calls = len(_calls(fake_nvcc))
    _no_nvcc(tmp_path, monkeypatch)
    aot._LOADED.clear()
    aot.toolkit_identity.cache_clear()
    for s in aot.SOURCES:
        assert aot.load(s)["path"].endswith(f"lib{s}.so")
    assert aot.stored() == list(aot.SOURCES)
    assert len(_calls(fake_nvcc)) == n_calls        # no build, no --version


def test_load_on_a_miss_builds_every_source(fake_nvcc):
    rec = aot.load("g1_ladder")
    assert rec["built"]
    assert sorted(c for c in _calls(fake_nvcc) if c != "--version") == \
        sorted(aot.SOURCES)


def test_empty_store_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CURDLEPROOFS_AOT_DIR", str(tmp_path / "store"))
    monkeypatch.setattr(aot, "_LOADED", {})
    _no_nvcc(tmp_path, monkeypatch)
    assert aot.maybe_load("fq_mul") is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        aot.load("fq_mul")
    K._lib.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K._lib("fq_mul", "fq_mul")
    # a CPU tensor still takes the plain version: no library involved
    a = torch.zeros((24, 3), dtype=torch.int32)
    assert torch.equal(K.fq_mul(a, a), K.fq_mul_plain(a, a))


def test_tmp_leftover_is_never_loaded(fake_nvcc, tmp_path, monkeypatch):
    d = aot.store_dir()
    d.mkdir(parents=True)
    (d / "libfq_mul.so.4242.tmp").write_text("half a library")
    assert aot.maybe_load("fq_mul") is None
    _no_nvcc(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        aot.load("fq_mul")
    # with a compiler the miss builds, and the leftover stays unread
    monkeypatch.setenv("CUDA_HOME", str(fake_nvcc))
    rec = aot.load("fq_mul")
    assert rec["built"] and "fake library of fq_mul" in \
        pathlib.Path(rec["path"]).read_text()


@pytest.mark.parametrize("damage", ["library byte", "library gone",
                                    "record key", "record torn"])
def test_damaged_artifact_is_rebuilt(fake_nvcc, damage):
    aot.export()
    d = aot.store_dir()
    so, meta = d / "libg1_add.so", d / "libg1_add.json"
    if damage == "library byte":
        so.write_bytes(so.read_bytes()[:-2] + b"X\n")
    elif damage == "library gone":
        so.unlink()
    elif damage == "record key":
        rec = json.loads(meta.read_text())
        meta.write_text(json.dumps({**rec, "key": "0" * 16}))
    else:
        meta.write_text(meta.read_text()[:40])
    aot._LOADED.clear()
    assert aot.maybe_load("g1_add") is None
    assert aot.maybe_load("fq_mul") is not None     # the others still hit
    before = _calls(fake_nvcc)
    rec = aot.load("g1_add")
    assert rec["built"]
    assert [c for c in _calls(fake_nvcc)[len(before):]
            if c != "--version"] == ["g1_add"]
    aot._LOADED.clear()
    assert aot.maybe_load("g1_add")["sha256"] == rec["sha256"]


def test_another_toolkit_rebuilds_when_building(fake_nvcc):
    first = aot.export()
    (fake_nvcc / "version.txt").write_text("fake nvcc, release 2.0")
    aot._LOADED.clear()
    # a load reads no toolkit: the stored libraries still hit
    assert aot.maybe_load("fq_mul")["toolkit"] == "fake nvcc, release 1.0"
    aot.toolkit_identity.cache_clear()
    second = aot.export()                           # building reads it
    assert all(r["built"] for r in second.values())
    assert {r["toolkit"] for r in second.values()} == {"fake nvcc, release 2.0"}
    assert all(second[s]["key"] != first[s]["key"] for s in aot.SOURCES)


def test_build_failure_raises_with_the_compiler_output(fake_nvcc,
                                                       monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "g1_sqrt")
    with pytest.raises(RuntimeError, match="fake failure"):
        aot.export()
    d = aot.store_dir()
    assert not (d / "libg1_sqrt.so").exists()
    assert not list(d.glob("*.tmp"))
    monkeypatch.delenv("FAKE_NVCC_FAIL")
    assert aot.maybe_load("g1_sqrt") is None
    assert aot.maybe_load("fq_mul") is not None     # the rest were stored


_RACE = """
import sys
sys.path.insert(0, {repo!r})
from curdleproofs_tpu_torch.ops import aot
recs = aot.export()
print("BUILT", sorted(s for s, r in recs.items() if r["built"]))
"""


def test_racing_processes_build_once(fake_nvcc):
    env = {**os.environ, "FAKE_NVCC_SLEEP": "1.0", "OMP_NUM_THREADS": "1"}
    code = _RACE.format(repo=str(_REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    built = sorted(o.split("BUILT", 1)[1].strip() for o, _ in outs)
    assert built == [repr(sorted(aot.SOURCES)), "[]"]
    assert sorted(c for c in _calls(fake_nvcc) if c != "--version") == \
        sorted(aot.SOURCES)


def test_disabled_store_keeps_the_tree_build_dir(fake_nvcc, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("CURDLEPROOFS_AOT", "0")
    monkeypatch.setattr(aot, "BUILD_DIR", tmp_path / "_build" / "cuda")
    recs = aot.export()
    tree_dir = tmp_path / "_build" / "cuda" / \
        f"cuda_s{aot._SCHEMA}_{aot._code_hash()}"
    assert sorted(recs) == sorted(aot.SOURCES)
    assert all(pathlib.Path(r["path"]).parent == tree_dir
               for r in recs.values())
    assert not (tmp_path / "store").exists()


def test_export_tool(fake_nvcc, tmp_path):
    from curdleproofs_tpu_torch.tools import aot_export

    out = tmp_path / "out" / "aot.json"
    assert aot_export.main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["match"] is True and art["built_s"] > 0
    assert set(art["sources"]) == set(aot.SOURCES)
    assert all(v["built"] for v in art["sources"].values())
    assert {"commit", "source_sha256", "torch", "card"} <= set(art["stamps"])
    assert art["stamps"]["card"].startswith("none")
    assert aot_export.main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert not any(v["built"] for v in art["sources"].values())
    assert art["built_s"] == 0
