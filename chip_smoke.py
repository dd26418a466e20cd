"""Drive the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. the card: name and power limit as nvidia-smi reports them;
2. build the nine CUDA sources from `curdleproofs_tpu_torch/csrc/` into
   an empty kernel store of this run's own (`ops/aot.py`; a temporary
   `CURDLEPROOFS_AOT_DIR`, so the build is a store miss, with each source's
   nvcc seconds), then hold each of the ten kernel wrappers of the MSM
   path against its plain PyTorch version on the card (array equality),
   timed with CUDA events: at
   the 626k MSM's own shapes (both folds on its plan, the merge's g1_add
   over its slots and its first scan step, the suffix kernel's chain entry,
   the reduction's scan step over W*G = 32,768 chunks, fq_mul at leave-
   Montgomery's [24, 3W], g1_sqrt over its 655,360 padded bases),
   g1_fold_rows on rows gathered from the first 2^17 slots of that plan (z
   from the liveness bit, so dead rows have z = 0), at the protocol's
   shapes from a real c = 8 plan (both entries of the suffix kernel at Cb =
   8, WG = 512, the tree against `g1_suffix_weighted_tree_plain`, then
   timed against each other in turns; fq_mul at leave-Montgomery's [24, 3W
   = 96]), fq_mul, g1_add and g1_add_rows at 2^16, g1_add at 32,768 lanes
   (the 626k reduction's W*G) and 512 lanes (the protocol's c = 8 W*G), and
   g1_sqrt at n = 128 (a protocol MSM's padded bases), g1_horner on window
   sums taken from the 626k fold's slots at 1536 relations (a table-mode
   same-msm round at B = 256) and 96 (slot mode's at B = 16), with the
   bound on the reference's count logged beside its own, then its G
   trial: the source built with the other lanes a relation (4 or 8,
   `kernel_probe.HornerVariant`, after the timed checks of g1_horner and
   with nothing else running beside its nvcc) and timed in turns with the
   store's kernel at both widths, the outputs equal. The three
   folds, the two suffix entries and fq_mul also carry `kernel_ms`, their
   device time without host gaps (`common.graph_ms`: launches captured in
   a CUDA graph). The ptxas registers, spills and stack of fq_mul, the three
   folds, g1_add, both suffix entries, g1_sqrt and g1_horner go into their
   records
   (g1_add's scan entry under `scan_registers`, `scan_spill_bytes`; the
   tree entry at Cb = 16 under `cb16_`), and the records of g1_fold_packed
   and g1_fold_rows their rows by kind (`kernel_probe.fold_row_kinds`, from
   which both kernels' bounds are counted); the 626k bases made resident
   compressed (x + parity, y from g1_sqrt) and uncompressed must be bit-
   identical, with each upload's wall time and bytes (after one untimed
   warm-up upload, three timed uploads each way, in turns);
3. the MSM at real size: `msm_device` at n = 2^16 (c = 8) and n = 626,000
   (c = 16, batch verification's deduped MSM at B = 1024, l = 252), each
   equal to the native host MSM, with per-stage device times and peak
   memory, and one fq_mul launch (leave-Montgomery; the bases were made
   resident before); then the 2^16 MSM again with the full-add fold
   (`madd=False`, the path of g1_fold_packed);
4. the protocol on `TorchBackend()`: the Whisk shuffle proof at l = 124 from
   `StdRng.seed_from_u64(0)` must equal the golden 4496-byte vector, verify,
   and fail with a tampered post-tracker; then prove and verify at l = 252;
   fq_mul launches once a device MSM (leave-Montgomery) and once an upload
   (the compressed ingest's parity product, one a g1_sqrt launch);
5. Whisk chain sync: 64 consecutive l = 124 shuffle blocks (made on the
   host backend) through `is_valid_whisk_shuffle_proofs` on the card:
   accepted; with one corrupted proof byte rejected, and `identify=True`
   names exactly that block;
6. batch verification at l = 252, B = 256 (shared R, S; fresh T, U, M per
   proof, as bench.py builds it): `batch_verify(..., stream_chunk=64)`
   through the device stream accepts it and rejects one swapped instance,
   and the one-MSM `batch_verify` gives the same verdicts.  No tuning
   table is shipped for the card, so the streamed run measures the untuned
   50/50 split between the device stream and the host engine;
7. the batched prover (`parallel.batch_prove`, one grouped MSM dispatch a
   folding round for the whole batch) on `TorchBackend()`:
   (a) table mode at l = 252, B = 256 (the reference's batched
   configuration): 8 proofs' bytes equal the port's sequential host
   prover's, all 256 batch-verify on the card, one swapped instance is
   rejected; then the fold at an IPA round's table plan (T = 136, over
   this batch's 4,194,305-entry table), its repack alone in turns with it,
   g1_horner at 1536 relations on that fold's window sums, g1_add at the
   table's multiples (d P + P over its bases) and fq_mul at the table's
   [24, 7N], each against its plain version; every dispatch's Horner stage
   is one g1_horner launch and nothing else;
   (b) slot mode (`CURDLEPROOFS_TABLE=0`) with the full-add fold at
   l = 124, B = 16: every proof's bytes equal the sequential host
   prover's, the merges made g1_add scan launches; then the full-add fold
   on a same-msm round's slot plan, the suffix kernel's tree entry on its
   c = 4 buckets and g1_horner on that round's window sums, against their
   plain versions.
   Each prints proofs/s against the sequential host prover's ms a proof,
   `batch_prove.last_timings` (bases_s with the table build table_s,
   pack_s, device_s, decode_s, host_other_s), peak memory and, per
   dispatch, each stage's device ms and kernel launches (upload, recode,
   plan, fold with its repack, merge, suffix, Horner).

8. the reference's other backends and the CLI:
   (a) the ladder kernel `g1_ladder` (csrc/g1_ladder.cu), its three entries
   (one scalar, one a point, the fold), against `g1_ladder_plain` after
   affine normalization (the GLV chain adds in another order) at n = 124
   and 252 (the grand product's widths) and 2^16, timed with CUDA events,
   with the kernel's ptxas record (one kernel: the entries are its
   run-time arguments);
   (b) phase 4's run on the all-device `DeviceBackend` (the reference's
   `TpuBackend`): the golden l = 124 bytes, verify, tamper rejected, l = 252
   proved and verified, the ladder launched on the path;
   (c) the autotuner (`tools/msm_autotune.py`) at 2^10, 2^12, 2^14 and 2^16
   into a temporary `CURDLEPROOFS_TUNE` table, every MSM equal to the
   host's; then phase 4's run on `HybridBackend` untuned (no MSM and no
   kernel on the card) and on that table (each MSM on the engine
   `route_to_device` names); the prove and verify walls of every backend;
   (d) `python -m curdleproofs_tpu_torch` shuffle-prove and shuffle-verify
   in subprocesses under `CURDLEPROOFS_BACKEND=hybrid` and `tpu`, and
   `info` naming the card.
9. multi-device on one card (`parallel/sharded_msm.py`,
   `parallel/distributed.py`), on logical grids: every cell of a (Dp, Dw)
   grid is cuda:0 and the cells run one after another, so the times show
   what sharding costs on one card, not how it scales:
   (a) the suffix kernel, the chunk suffix's scan step, the points-axis
   reduce's g1_add and leave-Montgomery's fq_mul at a window shard's shapes
   against their plain versions; `sharded_msm` at n = 64 on grids (1, 1),
   (2, 1), (4, 1), (4, 2), (8, 1), (2, 2) and (6, 1) (not a power of two:
   the host combines) and at a ragged n = 37 on (8, 1), each equal to the host MSM;
   phase 3's 626k MSM on (4, 2) and (8, 1), equal to phase 3's host result,
   with each cell's stage device ms, the points-axis reduce's, the host
   combine's, the wall and the peak memory, beside the unsharded
   `msm_device` wall on the same inputs;
   (b) under `CURDLEPROOFS_MADD=0` a (4, 2) run launches g1_fold_packed and
   no g1_fold_madd;
   (c) phase 6's batch through `batch_verify(..., mesh=<(4, 2) grid>)`: the
   one-MSM verdicts;
   (d) a backend sending every MSM of 8 or more terms through the (4, 2)
   grid: the seed-0 l = 124 Whisk proof equals the golden bytes, verifies,
   a tamper is rejected, and a mesh `batch_verify` of two l = 12 proofs
   accepts and rejects a swapped instance;
   (e) `curdleproofs_tpu_torch/tools/multihost_verify.py`: two gloo ranks
   on cuda:0 (`CURDLEPROOFS_BACKEND=torch`), the valid and the corrupt
   pass AND-reduced right on both; then `distributed_batch_verify` in this
   process with a (2, 1) grid.
   Every phase 9 line carries the card's name and power limit.
10. cold start (`ops/aot.py`, `ops/warmup.py`): three fresh processes of
   `tools/cold_start_probe.py` on the store phase 2 filled: at 2^16 points
   with CURDLEPROOFS_BG_INIT=0 and =1, and at 2^10 with `--first-launch`
   (each C entry's library binding, then its first launch, timed); each
   must find every library in the store (`aot_hit`), run no nvcc
   (`built_s` 0) and give MSMs equal to the host's, and the background
   init must record `init_s` and no error.
   The phase split (the miss's export and nvcc seconds, then each process's
   import, init, native, host generation, first touch, upload, first and
   second MSM) is printed.
11. the measurement tools (`curdleproofs_tpu_torch/tools/`), each once in
   this process at a small size into a temporary `--out`: `aot_export` (a
   hit: nothing rebuilt), `msm_sweep` at 2^10-2^12 with the 626k MSM's
   ints against bytes and the 2^12 shard proxy, `msm_profile` at 2^12,
   `grouped_profile` at one round of 256 relations x 128 columns,
   `batch_prove_bench` at B = 4, l = 28, `sync_floor_probe`,
   `speed_of_light` at 2^16, `scaling_report` and `multihost_scaling` at
   B = 8, l = 28; each artifact must hold its keys, `match` true and the
   stamps (commit, source sha256, torch version, this card's line).

Kernel launches are counted for each driven path on its own (zeroed just
before it, read just after it): the MSMs at 2^16 and 626k, the full-add
MSM, the protocol run of phase 4 (l = 124 and l = 252 together), the Whisk
chain, the batch verification, the two batched proves, phase 4's run on
`DeviceBackend` and on `HybridBackend` (untuned and tuned), and phase 9's
sharded MSMs (with and without the full-add switch), mesh batch verification
and protocol through the grid (g1_sqrt must launch on none). Each path must
launch every kernel `EXPECTED` lists for it. g1_fold_rows and g1_add_rows
have no caller (none in the JAX package either): they are held against
their plain versions in phase 2 and launch on no path. The kernels' JSON
record, on the line before the last, carries each kernel's counts on its
own main path under `launches` (the protocol run; for g1_fold_packed the
full-add MSM, for the suffix kernel's chain entry the 626k MSM, whose c =
16 reduction is the only one it serves on one device, for g1_ladder the run on
`DeviceBackend`; named in `launches_path`) and every path's under
`launches_by_path`, with its source's nvcc seconds (`build_s`, phase 2),
its C entries' library binding in a fresh process (`cold_lib_load_ms`)
and their first launches (`cold_first_launch_ms`, phase 10); the last line
is the device record.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the 626k MSM's data and the folds' inputs: one definition, shared with
# `kernel_probe.py fold`
from curdleproofs_tpu_torch.tools.kernel_probe import (
    FOLD_N as N_BIG, FOLD_ROWS_S, FOLD_SEED, FOLD_TILE as TILE, HornerVariant,
    fold_data, fold_inputs, fold_row_kinds, horner_g_trial,
)
# the card line, its integer bound and the graph timer: shared with the tools
from curdleproofs_tpu_torch.tools.common import (
    MUL32_PER_FQ_MUL, card_line, graph_ms, int_rate as card_int_rate,
)

ROOT = pathlib.Path(__file__).resolve().parent
TOOLS = ROOT / "curdleproofs_tpu_torch" / "tools"
COLD_LOGN = 16              # phase 10: the cold processes' MSM, 2^16 points
GOLDEN = ROOT / "tests" / "golden" / "whisk_shuffle_proof_128.hex"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
MUL32_PER_FQ_SQR = 468      # 78 + 12 + 144 products (squaring, then reduction)
N_SMALL = 1 << 16           # the c = 8 MSM family, and the kernels' width
CHAIN_BLOCKS = 64           # phase 5: Whisk blocks in the synced chain
BATCH_ELL, BATCH_B, BATCH_CHUNK = 252, 256, 64   # phase 6
PROVE_ELL, PROVE_B, PROVE_CHECKED = 252, 256, 8   # phase 7 (a), table mode
SLOT_ELL, SLOT_B = 124, 16                         # phase 7 (b), slot mode
MAIN_PATH = "protocol l=124 + l=252"
FULL_ADD_PATH = f"msm n={N_SMALL} full-add"
CHAIN_PATH = f"whisk chain {CHAIN_BLOCKS} x l=124"
BATCH_PATH = f"batch verify l={BATCH_ELL} B={BATCH_B}"
TABLE_PATH = f"batch prove table l={PROVE_ELL} B={PROVE_B}"
SLOT_PATH = f"batch prove slot l={SLOT_ELL} B={SLOT_B} full-add"
DEVICE_PATH = f"{MAIN_PATH} on DeviceBackend"
HYBRID_UNTUNED = f"{MAIN_PATH} on HybridBackend, untuned"
HYBRID_TUNED = f"{MAIN_PATH} on HybridBackend, autotuned table"
TUNE_LOGNS = (10, 12, 14, 16)                      # phase 8 (c)
# phase 9: (Dp, Dw) logical grids over the one card, at n = 64 and 626k
SHARD_GRIDS = ((1, 1), (2, 1), (4, 1), (4, 2), (8, 1), (2, 2), (6, 1))
SHARD_BIG_GRIDS = ((4, 2), (8, 1))
SHARD_PATH = "sharded msm on logical grids over cuda:0, n=64 and n=626000"
SHARD_FULL_ADD_PATH = "sharded msm (4, 2) n=64, CURDLEPROOFS_MADD=0"
MESH_BATCH_PATH = f"{BATCH_PATH} on a (4, 2) logical grid"
MESH_PROTOCOL_PATH = "whisk l=124 through a (4, 2) logical grid"
REPLACES = {
    "fq_mul": "curdleproofs_tpu/ops/pallas_kernels.py:269",
    "g1_add": "curdleproofs_tpu/ops/pallas_kernels.py:282",
    "g1_fold_madd": "curdleproofs_tpu/ops/pallas_kernels.py:447",
    "g1_suffix_weighted": "curdleproofs_tpu/ops/pallas_kernels.py:506",
    "g1_suffix_weighted_tree": "curdleproofs_tpu/ops/pallas_kernels.py:506",
    "g1_fold_packed": "curdleproofs_tpu/ops/pallas_kernels.py:440",
    "g1_sqrt": "curdleproofs_tpu/ops/pallas_kernels.py:202",
    "g1_fold_rows": "curdleproofs_tpu/ops/pallas_kernels.py:454",
    "g1_add_rows": "curdleproofs_tpu/ops/pallas_kernels.py:527",
    "g1_ladder": "curdleproofs_tpu/ops/msm.py:73",
    "g1_horner": "curdleproofs_tpu/ops/msm_grouped.py:255",
}
NO_CALLER = {"g1_fold_rows", "g1_add_rows"}
BIG_PATH = f"msm n={N_BIG}"
# the suffix kernel's entries: the tree serves the c = 8 reduction (WG =
# 512), the chain the c = 16 one (WG = 32,768)
_MSM8 = {"fq_mul", "g1_add", "g1_fold_madd", "g1_suffix_weighted_tree"}
_MSM16 = {"fq_mul", "g1_add", "g1_fold_madd", "g1_suffix_weighted"}
# the kernels each driven path must launch: g1_sqrt wherever the counted
# window uploads fresh bases (the direct MSMs' bases are resident before
# their windows open); every MSM below 2^19 points runs c = 8
EXPECTED = {
    f"msm n={N_SMALL}": _MSM8,
    BIG_PATH: _MSM16,
    FULL_ADD_PATH: _MSM8 - {"g1_fold_madd"} | {"g1_fold_packed"},
    MAIN_PATH: _MSM8 | {"g1_sqrt"},
    CHAIN_PATH: _MSM8 | {"g1_sqrt"},
    BATCH_PATH: _MSM8 | {"g1_sqrt"},
    # the batched prover: one compressed upload, the table's multiples and
    # products (table mode), the fold, Horner (one g1_horner a dispatch);
    # slot mode also the merge's scan steps (checked per stage) and the
    # c = 4 reduction, n_rel * 64 <= 8192 lanes: the tree entry
    TABLE_PATH: {"fq_mul", "g1_add", "g1_fold_madd", "g1_sqrt", "g1_horner"},
    SLOT_PATH: {"fq_mul", "g1_add", "g1_fold_packed", "g1_sqrt",
                "g1_suffix_weighted_tree", "g1_horner"},
    # the all-device backend: the MSMs from 8 points, and the ladder for
    # the commitment's and the grand product's scalar multiplications
    DEVICE_PATH: _MSM8 | {"g1_sqrt", "g1_ladder"},
    # HybridBackend: untuned no MSM of a prove reaches the card (all under
    # 2^16 points); on the table, wherever `route_to_device` says
    HYBRID_UNTUNED: set(),
    HYBRID_TUNED: set(),
    # the sharded MSM: plain uploads (no g1_sqrt), the points-axis reduce's
    # g1_add; c = 8 below 2^18 points (the tree entry where a cell keeps
    # all 32 windows, Cb = 8; the chain at Cb = 4, a (4, 2) grid's window
    # shard), c = 16 at 626k (the chain)
    SHARD_PATH: _MSM8 | {"g1_suffix_weighted"},
    SHARD_FULL_ADD_PATH: {"fq_mul", "g1_add", "g1_fold_packed",
                          "g1_suffix_weighted"},
    MESH_BATCH_PATH: {"fq_mul", "g1_add", "g1_fold_madd",
                      "g1_suffix_weighted"},
    MESH_PROTOCOL_PATH: {"fq_mul", "g1_add", "g1_fold_madd",
                         "g1_suffix_weighted"},
}
# each kernel's own main path, where it is not the protocol run
OWN_PATH = {"g1_fold_packed": FULL_ADD_PATH, "g1_suffix_weighted": BIG_PATH,
            "g1_ladder": DEVICE_PATH, "g1_horner": TABLE_PATH}
# g1_horner's widths: a same-msm round's relations (6 a proof) in table
# mode at B = 256 and in slot mode at B = 16
HORNER_RELS = (6 * PROVE_B, 6 * SLOT_B)
# a relation's chain of dependent products in g1_horner: two levels a point
# operation, 320 of them, and leave-Montgomery's one (one thread running
# the reference's 320 complete adds: 3,843)
HORNER_CHAIN = 320 * 2 + 1


def log(*a):
    print(*a, flush=True)


def sqrt_mul32(digits) -> int:
    """32-bit multiplies one point needs for (x^3 + b)^e, e given as the
    MSB-first 2-bit `digits`: x^2 and u^2 squared, x^3 and u^3 multiplied,
    then, after the first nonzero digit (which only loads u^d), two
    squarings a digit and one multiply a nonzero digit.  The kernel also
    squares Montgomery one and multiplies by it on zero digits, to stay
    branch-free; the bound does not count that work."""
    first = next(j for j, d in enumerate(digits) if d)
    rest = digits[first + 1:]
    squarings = 2 + 2 * len(rest)
    products = 2 + sum(1 for d in rest if d)
    return squarings * MUL32_PER_FQ_SQR + products * MUL32_PER_FQ_MUL


def horner_mul32(reference: bool = False) -> int:
    """32-bit multiplies of one relation's Horner step: 256 complete
    doublings (6 products and 2 squarings) and 64 complete adds (12
    products), or with `reference` the reference's 320 complete adds, then
    3 products to leave Montgomery form."""
    dbl = (12 * MUL32_PER_FQ_MUL if reference
           else 6 * MUL32_PER_FQ_MUL + 2 * MUL32_PER_FQ_SQR)
    return 256 * dbl + (64 * 12 + 3) * MUL32_PER_FQ_MUL


def event_ms(fn, reps: int):
    """(result of the first run, mean device time of `fn` over `reps` runs).
    With reps > 1 neither the first run nor a second one is timed: the first
    run's result is still held, so the second gives the caching allocator
    free blocks of the outputs' sizes.  Otherwise the first timed run could
    wait on cudaMalloc and count the card's idle time as the kernel's."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    if reps > 1:
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def affine_err(got, want, fq_mul) -> int:
    """Max |difference| of the cross products X1 Z2, X2 Z1 and Y1 Z2, Y2 Z1
    of two [24, n] point batches (Montgomery products, `fq_mul`): 0 where
    each pair is one point (affine normalization without an inversion).
    Each `got` point must be a valid representative: z = 0 only as
    (0 : y : 0) with y != 0."""
    gx, gy, gz = got
    wx, wy, wz = want
    inf = ~gz.bool().any(dim=0)
    if (inf & (gx.bool().any(dim=0) | ~gy.bool().any(dim=0))).any():
        raise AssertionError("a point at z = 0 that is not (0 : y : 0)")
    return max(max_abs_err((fq_mul(gx, wz),), (fq_mul(wx, gz),)),
               max_abs_err((fq_mul(gy, wz),), (fq_mul(wy, gz),)))


def stage_ms(marks) -> dict:
    """[(stage, event), ...] -> {stage: ms since the previous mark}."""
    return {s: round(marks[i - 1][1].elapsed_time(e), 3)
            for i, (s, e) in enumerate(marks) if i}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)  # name, power limit: as nvidia-smi reports them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    from curdleproofs_tpu_torch.backend import HostBackend, use_backend
    from curdleproofs_tpu_torch.constants import R, WHISK_ELL
    from curdleproofs_tpu_torch.crs import CurdleproofsCrs
    from curdleproofs_tpu_torch.curdleproofs import (
        CurdleproofsProof, generate_crs,
    )
    from curdleproofs_tpu_torch.host import native
    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import aot
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops import msm_device as md
    from curdleproofs_tpu_torch.ops.backend import TorchBackend
    from curdleproofs_tpu_torch.ops.field import FQ
    from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ, points_to_device
    from curdleproofs_tpu_torch.parallel import batch_verify as bv
    from curdleproofs_tpu_torch.util import (
        generate_blinders, get_permutation, msm,
        shuffle_permute_and_commit_input,
    )
    from curdleproofs_tpu_torch.whisk import (
        WhiskTracker, generate_whisk_shuffle_proof, is_valid_whisk_shuffle_proof,
        is_valid_whisk_shuffle_proofs,
    )

    # -- phase 2: build, then every kernel against its plain version -------
    # the build is the kernel store's export into an empty store (a miss:
    # `__main__` points CURDLEPROOFS_AOT_DIR at a new temporary directory),
    # which phase 10's cold processes then load from
    t0 = time.perf_counter()
    exported = aot.export()
    export_s = time.perf_counter() - t0
    if not all(r["built"] for r in exported.values()):
        raise AssertionError("the kernel store was not empty: "
                             f"{sorted(s for s, r in exported.items() if not r['built'])}")
    reports = {s: r["ptxas"] for s, r in exported.items()}
    log(f"build: {export_s:.1f} s (nvcc, one per source, in parallel, into "
        f"the empty kernel store {aot.store_dir()}); nvcc s by source "
        + json.dumps({s: round(r["build_s"], 2) for s, r in exported.items()}))
    for k, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k}: {line.strip()}")
    if not native.available():
        raise RuntimeError("native host runtime failed to build (g++)")

    int_rate = card_int_rate(0)
    log(f"bound rates: {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{int_rate / 1e12:.2f} T 32-bit multiplies/s")

    def bound(nbytes: float, nmul: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S, nmul / int_rate
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    rnd = random.Random(FOLD_SEED)
    rng = StdRng.seed_from_u64(FOLD_SEED)
    tile, big_pts, big_ss = fold_data(rng, rnd)

    def tiled(n, shift=0):
        return [tile[(i + shift) % TILE] for i in range(n)]

    records = {}

    def check(name, shape, kernel, plain, reps, nbytes, nmul, graph=False,
              affine=False):
        """Hold `kernel` against `plain` (array equality; with `affine`, the
        points after affine normalization, `affine_err`) and time both
        (`graph`: also the kernel's device time without host gaps).  The
        first check of a kernel fills its record, later ones (other shapes
        of the same kernel) go under its `more_shapes`."""
        got, ms = event_ms(kernel, reps)
        want, plain_ms = event_ms(plain, 1)
        err = (affine_err(got, want, K.fq_mul_plain) if affine
               else max_abs_err(got, want))
        if err != 0:
            raise AssertionError(f"kernel {name} at {shape} disagrees with "
                                 f"its plain version: max |diff| = {err}")
        b_ms, b_by = bound(nbytes, nmul)
        at = {"shape": shape, "match": True, "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        if affine:
            at["compared"] = "after affine normalization"
        if graph:
            at["kernel_ms"] = graph_ms(kernel)
        if name in records:
            records[name]["more_shapes"].append(at)
        else:
            records[name] = {
                "name": name, "route": "cuda",
                "source": f"curdleproofs_tpu_torch/csrc/"
                          f"{K.source_of(name)}.cu",
                "replaces": REPLACES[name], **at, "library_ms": None,
                "more_shapes": []}
        log(f"kernel {name} at {shape}: equal to plain"
            + (" after affine normalization" if affine else "")
            + f"; {ms:.4f} ms "
            + (f"(kernel {at['kernel_ms']:.4f} ms) " if graph else "")
            + f"(plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
        return got

    def with_ptxas(name, entry, prefix=""):
        """ptxas' `registers`, `spill_bytes` and `stack_bytes` of kernel
        `entry` into the record of `name`."""
        usage = K.ptxas_usage(reports[K.source_of(name)], entry)
        if set(usage) != {"registers", "spill_bytes", "stack_bytes"}:
            raise AssertionError(f"no ptxas report for {entry}: {usage}")
        records[name].update({prefix + k: v for k, v in usage.items()})

    # The 626k bases made resident both ways: one untimed warm-up upload
    # (the process's first loads the kernels and warms the allocator), then
    # three timed each way in turns; bit-identical layouts, each upload's
    # wall and bytes, and the host export's share of it.
    n_pad = md.pad_n(N_BIG)
    sent = {"1": 4 * (12 + 1) * n_pad, "0": 4 * (12 + 12 + 1) * n_pad}
    walls = {"1": [], "0": []}
    layouts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    md.DeviceBases(big_pts, dev)
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    for flag in ("1", "0", "0", "1", "1", "0"):
        os.environ["CURDLEPROOFS_COMPRESS"] = flag
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layouts[flag] = md.DeviceBases(big_pts, dev)
        torch.cuda.synchronize()
        walls[flag].append((time.perf_counter() - t0) * 1e3)
    del os.environ["CURDLEPROOFS_COMPRESS"]
    big_bases = layouts.pop("1")
    unc = layouts.pop("0")
    for a, b, what in zip((big_bases.ext_px, big_bases.ext_py,
                           big_bases.ext_zb), (unc.ext_px, unc.ext_py,
                                               unc.ext_zb),
                          ("ext_px", "ext_py", "ext_zb")):
        if not torch.equal(a, b):
            raise AssertionError(f"compressed and uncompressed residency "
                                 f"differ in {what}")
    del unc
    t0 = time.perf_counter()
    px, _ = native.export_mont_x(big_pts, n_pad)
    export_c = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    native.export_mont_affine(big_pts, n_pad)
    export_u = (time.perf_counter() - t0) * 1e3
    ingest = {"points": N_BIG, "padded": n_pad, "warmup_ms": warmup_ms,
              "compressed": {"wall_ms": walls["1"], "bytes": sent["1"],
                             "host_export_ms": export_c},
              "uncompressed": {"wall_ms": walls["0"], "bytes": sent["0"],
                               "host_export_ms": export_u}}
    log(f"bases n={N_BIG}: compressed and uncompressed residency "
        f"bit-identical; upload " + json.dumps(ingest))

    # The 626k MSM's own shapes (the device's real load): both folds on its
    # plan, the merge's first g1_add over all its slots, the suffix kernel
    # at its WG = 16 x 2048, Cb = 16, fq_mul at its leave-Montgomery
    # [24, W] x [24, 1], and g1_sqrt over its padded bases' x.
    params, ext, sp, rows = fold_inputs(big_bases, big_ss)
    kinds = fold_row_kinds(*ext, sp.plan)
    e_cnt, (t_rows, s_pad) = ext[0].shape[1], sp.plan.shape
    log(f"fold family: {params}, plan rows by kind {json.dumps(kinds)}")
    fold_bytes = (2 * 48 + 4) * e_cnt + 4 * t_rows * s_pad + 3 * 96 * s_pad
    acc = PointsXYZ(*check(
        "g1_fold_madd", f"plan [{t_rows}, {s_pad}] over {e_cnt} bases",
        lambda: K.g1_fold_madd(*ext, sp.plan),
        lambda: K.g1_fold_madd_plain(*ext, sp.plan), 3,
        fold_bytes, kinds["live"] * 11 * MUL32_PER_FQ_MUL, graph=True))
    with_ptxas("g1_fold_madd", "g1_fold_kernel")
    # The full-add fold writes the complete add's words on every row, dead
    # ones too.  Its bound counts the least work that writes the same words
    # (`fold_row_kinds`): 11 products a live row, and of the T x S - live
    # dead rows 3 a row (0 : +-1 : 0), 5 another (0 : y : 0), 12 one whose
    # x is not 0.
    check("g1_fold_packed", f"plan [{t_rows}, {s_pad}] over {e_cnt} bases",
          lambda: K.g1_fold_packed(*ext, sp.plan),
          lambda: K.g1_fold_packed_plain(*ext, sp.plan), 3,
          fold_bytes, kinds["products"] * MUL32_PER_FQ_MUL, graph=True)
    records["g1_fold_packed"]["row_kinds"] = kinds
    with_ptxas("g1_fold_packed", "g1_fold_kernel")

    # g1_fold_rows on [24, T, S] rows gathered from the plan's first slots,
    # z rebuilt from the liveness bit (dead rows z = 0, added all the same).
    # The kernel runs the complete add on every row, but its bound, as the
    # full-add fold's, counts the least work that writes the same words:
    # these rows have z = one (live) or z = 0 (dead), so the same
    # `fold_row_kinds` count of products applies.
    rows_kinds = fold_row_kinds(*ext, sp.plan[:, :FOLD_ROWS_S])
    check("g1_fold_rows", f"[24, {t_rows}, {FOLD_ROWS_S}] rows of the plan",
          lambda: K.g1_fold_rows(*rows), lambda: K.g1_fold_rows_plain(*rows),
          3, 3 * 96 * t_rows * FOLD_ROWS_S + 3 * 96 * FOLD_ROWS_S,
          rows_kinds["products"] * MUL32_PER_FQ_MUL, graph=True)
    records["g1_fold_rows"]["row_kinds"] = rows_kinds
    with_ptxas("g1_fold_rows", "g1_fold_rows_kernel")
    del rows

    # g1_horner on window sums taken from the fold's slots (projective
    # representatives of real bucket sums, [24, n_rel, 64]) at both of
    # HORNER_RELS, array-equal to the plain version (the complete doubling
    # gives the complete self-add's words on the curve).  Bound: a
    # relation's 256 complete doublings (6 products, 2 squarings), 64
    # complete adds (12 products) and 3 products, the [24, n_rel, 64] sums
    # read and [3, 24, n_rel] written once.  The log line beside it gives
    # the bound on the reference's count (320 complete adds) and the
    # chain's length; neither goes into the kernels line.
    def horner_check(shape, ws):
        n_rel = ws[0].shape[1]
        check("g1_horner", shape, lambda: (K.g1_horner(*ws),),
              lambda: (K.g1_horner_plain(*ws),), 5,
              3 * 96 * 64 * n_rel + 3 * 48 * n_rel, n_rel * horner_mul32())
        log(f"  g1_horner at n_rel = {n_rel}: bound on the reference's "
            f"count {bound(0, n_rel * horner_mul32(reference=True))[0]:.4f}"
            f" ms; a relation's chain {HORNER_CHAIN} dependent products")

    horner_ws = [tuple(c[:, :n_rel * 64].reshape(24, n_rel, 64) for c in acc)
                 for n_rel in HORNER_RELS]
    for ws in horner_ws:
        horner_check(f"n_rel = {ws[0].shape[1]} (window sums from the 626k "
                     f"fold's slots)", ws)
    with_ptxas("g1_horner", "g1_horner_kernel")
    # the G trial builds its variant here, after g1_horner's timed checks
    # and with no other work beside the nvcc, then times it in turns
    trial = horner_g_trial(HornerVariant(aot.aot_dir() / "g1_horner_trial"),
                           horner_ws)
    records["g1_horner"]["g_trial"] = trial
    log(f"g1_horner G trial ({trial['turns']}; nvcc of the variant "
        f"{trial['variant_build_s']:.1f} s, ptxas {trial['variant_ptxas']}): "
        + json.dumps(trial["ms"]))
    del horner_ws

    partner = torch.clamp(torch.arange(s_pad, device=dev) + 1, max=s_pad - 1)
    nxt = PointsXYZ(*(c[:, partner] for c in acc))
    check("g1_add", f"merge N = {s_pad}", lambda: K.g1_add(acc, nxt),
          lambda: K.g1_add_plain(acc, nxt), 5,
          9 * 96 * s_pad, s_pad * 12 * MUL32_PER_FQ_MUL)
    with_ptxas("g1_add", "g1_add_kernel")
    with_ptxas("g1_add", "g1_add_scan_kernel", "scan_")

    def scan_check(shape, v, key, stride, reps):
        """g1_add's scan entry: one merge or suffix round; its bound counts
        the lanes whose partner holds the same key (the others copy)."""
        n = key.shape[0]
        live = int((key[stride:] == key[:n - stride]).sum()) \
            if stride < n else 0
        check("g1_add", f"{shape}, stride {stride} ({live} lanes add)",
              lambda: K.g1_add_scan(v, key, stride),
              lambda: K.g1_add_scan_plain(v, key, stride), reps,
              (2 * 288 + 8) * n, live * 12 * MUL32_PER_FQ_MUL)

    scan_check(f"scan step, merge N = {s_pad}", acc, sp.slot_gkey, 1, 5)

    def suffix_cost(cb, wg):
        """bytes and 32-bit multiplies of the suffix function at (Cb, WG):
        the chain's 2 Cb complete adds a lane, whichever entry runs"""
        return 3 * 96 * cb * wg + 6 * 96 * wg, wg * cb * 2 * 12 * \
            MUL32_PER_FQ_MUL

    g_chunks, cb = md._phase3_chunks(params.c, params.windows)
    wg = params.windows * g_chunks
    idx = torch.arange(cb * wg, device=dev) % s_pad
    dense = [c[:, idx].reshape(24, cb, wg) for c in acc]
    tg = check("g1_suffix_weighted", f"Cb = {cb}, WG = {wg} (chain entry)",
               lambda: sum(K.g1_suffix_weighted(*dense, tree=False), ()),
               lambda: sum(K.g1_suffix_weighted_plain(*dense), ()), 5,
               *suffix_cost(cb, wg))
    with_ptxas("g1_suffix_weighted", "g1_suffix_weighted_kernel")
    wkey = torch.arange(wg, device=dev) // g_chunks
    scan_check(f"scan step, reduction W*G = {wg} (G = {g_chunks})",
               PointsXYZ(*tg[:3]), wkey, 1, 20)

    # The protocol's shapes, from a real c = 8 plan (a 256-point MSM:
    # fold, merge and dense buckets as the pipeline makes them): both
    # suffix entries at its [24, 8, 512], then timed in turns; fq_mul at
    # its leave-Montgomery [24, 3W]
    p8 = md.pick_params(256)
    b8 = md.DeviceBases(tiled(256, 11), dev)
    l8 = torch.from_numpy(md._scalars_to_limbs(
        [rnd.randrange(R) for _ in range(256)], p8.n).astype(np.int32)).to(dev)
    sp8 = md._slot_plan(md._signed_digits(l8, p8.n, p8.c), n=p8.n, c=p8.c,
                        t_rows=p8.t_rows, s_pad=p8.s_pad)
    acc8 = md._suffix_scan(K.g1_fold_madd(b8.ext_px, b8.ext_py, b8.ext_zb,
                                          sp8.plan), sp8.slot_gkey, sp8.kmax)
    d8 = md._dense_buckets(acc8, sp8.firstmap, p8.c, p8.windows)
    cb8, wg8 = d8.x.shape[1:]
    shape8 = f"Cb = {cb8}, WG = {wg8} (c = 8 plan of 256 points)"
    check("g1_suffix_weighted", shape8 + ", chain entry",
          lambda: sum(K.g1_suffix_weighted(*d8, tree=False), ()),
          lambda: sum(K.g1_suffix_weighted_plain(*d8), ()), 20,
          *suffix_cost(cb8, wg8), graph=True)
    check("g1_suffix_weighted_tree", shape8,
          lambda: sum(K.g1_suffix_weighted_tree(*d8), ()),
          lambda: sum(K.g1_suffix_weighted_tree_plain(*d8), ()), 20,
          *suffix_cost(cb8, wg8), graph=True)
    with_ptxas("g1_suffix_weighted_tree", "g1_suffix_tree_kernelILi8E")
    with_ptxas("g1_suffix_weighted_tree", "g1_suffix_tree_kernelILi16E",
               "cb16_")
    turns = {"chain": [], "tree": []}
    for entry in ("chain", "tree", "tree", "chain"):
        turns[entry].append(graph_ms(
            lambda: K.g1_suffix_weighted(*d8, tree=entry == "tree")))
    gain = 1 - sum(turns["tree"]) / sum(turns["chain"])
    records["g1_suffix_weighted_tree"]["against_chain"] = {
        "shape": shape8, "turns": "chain, tree, tree, chain",
        "chain_kernel_ms": turns["chain"], "tree_kernel_ms": turns["tree"],
        "tree_gain": gain, "routed_to_tree": K.suffix_uses_tree(cb8, wg8)}
    log(f"suffix entries at {shape8}, in turns: chain {turns['chain']} ms, "
        f"tree {turns['tree']} ms: the tree {100 * gain:.1f}% faster")

    one_plain = FQ.plain_const(1, (1,), dev)
    for v, w, what in ((acc8, p8.windows, "the protocol's"),
                       (acc, params.windows, "the 626k MSM's")):
        lm = torch.cat([c[:, :w] for c in v], dim=1)
        check("fq_mul", f"leave-Montgomery [24, 3W = {3 * w}] x [24, 1] "
              f"({what})", lambda: (K.fq_mul(lm, one_plain),),
              lambda: (K.fq_mul_plain(lm, one_plain),),
              50, 2 * 96 * 3 * w + 96, 3 * w * MUL32_PER_FQ_MUL, graph=True)
    with_ptxas("fq_mul", "fq_mul_kernel")
    del b8, l8, sp8, acc8, d8, lm

    pxp = md.u32_to_tensor(px, dev)
    check("g1_sqrt", f"n = {n_pad} (x of the 626k MSM's padded bases)",
          lambda: (K.g1_sqrt(pxp),), lambda: (K.g1_sqrt_plain(pxp),), 3,
          (48 + 96) * n_pad, n_pad * sqrt_mul32(K.SQRT_DIGITS))
    with_ptxas("g1_sqrt", "g1_sqrt_kernel")
    px128 = pxp[:, :128].contiguous()
    check("g1_sqrt", "n = 128 (a protocol MSM's padded bases)",
          lambda: (K.g1_sqrt(px128),), lambda: (K.g1_sqrt_plain(px128),), 50,
          (48 + 96) * 128, 128 * sqrt_mul32(K.SQRT_DIGITS))

    # fq_mul and g1_add also at N = 2^16 lanes
    n16 = N_SMALL
    a = points_to_device(tiled(n16), dev)
    b = points_to_device(tiled(n16, 7), dev)
    pp = K.g1_add_plain(a, b)     # general z, as the merge and scans see
    check("fq_mul", f"N = {n16}", lambda: (K.fq_mul(pp.x, pp.y),),
          lambda: (K.fq_mul_plain(pp.x, pp.y),),
          50, 3 * 96 * n16, n16 * MUL32_PER_FQ_MUL, graph=True)
    check("g1_add", f"N = {n16}", lambda: K.g1_add(pp, b),
          lambda: K.g1_add_plain(pp, b),
          20, 9 * 96 * n16, n16 * 12 * MUL32_PER_FQ_MUL)
    check("g1_add_rows", f"N = {n16}", lambda: K.g1_add_rows(pp, b),
          lambda: K.g1_add_rows_plain(pp, b),
          20, 9 * 96 * n16, n16 * 12 * MUL32_PER_FQ_MUL)
    for nw, what in ((32_768, "the 626k reduction's W*G"),
                     (512, "the protocol's c = 8 W*G")):
        pw, bw = (PointsXYZ(*(c[:, :nw].contiguous() for c in v))
                  for v in (pp, b))
        check("g1_add", f"N = {nw} ({what})", lambda: K.g1_add(pw, bw),
              lambda: K.g1_add_plain(pw, bw), 100, 9 * 96 * nw,
              nw * 12 * MUL32_PER_FQ_MUL)
    del pp, a, b, pw, bw, dense, tg, wkey, sp, acc, nxt, pxp
    del px128, px

    # -- phases 3 to 6: each path counted on its own ------------------------
    by_path = {}

    def counted(path):
        """Launch counts of one driven path: zeroed just before it, read
        just after it; every kernel `EXPECTED[path]` names must have
        launched in it."""
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        log(f"kernel launches, {path}: {json.dumps(launches)}")
        missing = sorted(k for k in EXPECTED[path] if launches[k] == 0)
        if missing:
            raise AssertionError(f"kernels never launched on {path}: "
                                 f"{missing}")
        by_path[path] = launches

    host = HostBackend()
    host_want = {}                # phase 3's host results, reused in phase 9
    small_pts = tiled(n16, 3)
    small_ss = [rnd.randrange(R) for _ in range(n16)]
    small_bases = md.DeviceBases(small_pts, dev)
    for path, pts, ss, bases, madd in (
            (f"msm n={n16}", small_pts, small_ss, small_bases, True),
            (BIG_PATH, big_pts, big_ss, big_bases, True),
            (FULL_ADD_PATH, small_pts, small_ss, small_bases, False)):
        n = len(pts)
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        mark("start")
        got = md.msm_device(bases, ss, mark=mark, madd=madd)
        wall = (time.perf_counter() - t0) * 1e3
        counted(path)
        if not madd and by_path[path]["g1_fold_madd"]:
            raise AssertionError("madd=False still ran the madd fold")
        if by_path[path]["fq_mul"] != 1:
            raise AssertionError(f"{path}: leave-Montgomery took "
                                 f"{by_path[path]['fq_mul']} fq_mul launches")
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        want = host.msm(pts, ss)
        host_ms = (time.perf_counter() - t0) * 1e3
        if got != want:
            raise AssertionError(f"{path} differs from the host MSM")
        host_want[path] = want
        p = md.pick_params(n)
        log(f"{path} c={p.c} T={p.t_rows} s_pad={p.s_pad}: equal to host; "
            f"wall {wall:.1f} ms (host native {host_ms:.1f} ms), peak "
            f"{peak:.2f} GiB, stages ms " + json.dumps(stage_ms(marks)))
    del big_bases, small_bases

    golden = GOLDEN.read_text().strip()

    def protocol_run(backend, label: str) -> dict:
        """On `backend`: the Whisk shuffle proof at l = 124 from
        `StdRng.seed_from_u64(0)` must equal the golden 4496 bytes, verify,
        and fail with a tampered post-tracker; then prove and verify at
        l = 252.  Launch counts are zeroed just before the l = 124 prove;
        returns the walls in ms."""
        walls = {}
        with use_backend(backend):
            rng = StdRng.seed_from_u64(0)
            crs = CurdleproofsCrs.generate_crs(WHISK_ELL)
            pre = [WhiskTracker.from_rand(rng) for _ in range(WHISK_ELL)]
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            post, proof = generate_whisk_shuffle_proof(rng, crs, pre)
            walls["l124_prove_ms"] = (time.perf_counter() - t0) * 1e3
            if proof.hex() != golden or len(proof) != 4496:
                raise AssertionError(f"{label}: l=124 whisk shuffle proof "
                                     f"differs from the golden vector")
            t0 = time.perf_counter()
            ok = is_valid_whisk_shuffle_proof(rng, crs, pre, post, proof)
            walls["l124_verify_ms"] = (time.perf_counter() - t0) * 1e3
            tampered = [WhiskTracker.from_rand(StdRng.seed_from_u64(9))] \
                + post[1:]
            if not ok or is_valid_whisk_shuffle_proof(rng, crs, pre,
                                                      tampered, proof):
                raise AssertionError(f"{label}: whisk verification "
                                     f"accepted/rejected wrongly")
            log(f"{label}: whisk l=124 proof equals the golden 4496 bytes; "
                f"prove {walls['l124_prove_ms']:.1f} ms, verify "
                f"{walls['l124_verify_ms']:.1f} ms, tamper rejected")

            ell = 252
            rng = StdRng.seed_from_u64(252)
            crs = generate_crs(ell)
            perm = list(range(ell))
            rng.shuffle(perm)
            k = rng.rand_fr()
            vr = [rng.rand_g1() for _ in range(ell)]
            vs = [rng.rand_g1() for _ in range(ell)]
            T, U, M, mb = shuffle_permute_and_commit_input(crs, vr, vs, perm,
                                                           k, rng)
            t0 = time.perf_counter()
            pr = CurdleproofsProof.new(crs, vr, vs, T, U, M, perm, k, mb, rng)
            walls["l252_prove_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            pr.verify(crs, vr, vs, T, U, M, rng)   # raises VerificationError
            walls["l252_verify_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"{label}: l=252 prove {walls['l252_prove_ms']:.1f} ms, verify "
            f"{walls['l252_verify_ms']:.1f} ms, {len(pr.serialize())} bytes")
        return walls

    backend = TorchBackend()
    prove_walls = {"TorchBackend": protocol_run(backend, "TorchBackend")}
    counted(MAIN_PATH)
    log(f"msm engines on {MAIN_PATH}: {json.dumps(backend.engine_counts)}")
    if backend.engine_counts["device"] == 0:
        raise AssertionError("no MSM reached the device")
    want_mul = backend.engine_counts["device"] + by_path[MAIN_PATH]["g1_sqrt"]
    if by_path[MAIN_PATH]["fq_mul"] != want_mul:
        raise AssertionError(f"{MAIN_PATH}: {by_path[MAIN_PATH]['fq_mul']} "
                             f"fq_mul launches, not one a device MSM and one "
                             f"an upload ({want_mul})")

    # -- phase 5: Whisk chain sync -------------------------------------------
    rng = StdRng.seed_from_u64(64)
    crs = CurdleproofsCrs.generate_crs(WHISK_ELL)
    trackers = [WhiskTracker.from_rand(rng) for _ in range(WHISK_ELL)]
    shuffles = []
    t0 = time.perf_counter()
    with use_backend(HostBackend()):
        for _ in range(CHAIN_BLOCKS):
            post, proof = generate_whisk_shuffle_proof(rng, crs, trackers)
            shuffles.append((trackers, post, proof))
            trackers = post
    gen_s = time.perf_counter() - t0
    bad_block = 37
    pre, post, proof = shuffles[bad_block]
    bad = bytearray(proof)
    bad[-32] ^= 1                 # the low byte of the proof's last scalar
    tampered = shuffles[:bad_block] + [(pre, post, bytes(bad))] \
        + shuffles[bad_block + 1:]
    chain_backend = TorchBackend()
    with use_backend(chain_backend):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        ok = is_valid_whisk_shuffle_proofs(rng, crs, shuffles)
        accept_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rejected = not is_valid_whisk_shuffle_proofs(rng, crs, tampered)
        reject_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        verdicts = is_valid_whisk_shuffle_proofs(rng, crs, tampered,
                                                 identify=True)
        identify_ms = (time.perf_counter() - t0) * 1e3
        counted(CHAIN_PATH)
    named = [i for i, v in enumerate(verdicts) if not v] \
        if isinstance(verdicts, list) else verdicts
    if not ok or not rejected or named != [bad_block]:
        raise AssertionError(f"whisk chain: accepted {ok}, tamper rejected "
                             f"{rejected}, identify named {named}")
    log(f"{CHAIN_PATH}: accepted in {accept_ms:.1f} ms, block {bad_block} "
        f"corrupted: rejected in {reject_ms:.1f} ms, identify named "
        f"{named} in {identify_ms:.1f} ms; blocks made on the host in "
        f"{gen_s:.1f} s; msm engines "
        + json.dumps(chain_backend.engine_counts))

    # -- phase 6: batch verification, streamed and one-MSM -------------------
    ell, n_b = BATCH_ELL, BATCH_B
    rng = StdRng.seed_from_u64(256)
    crs = generate_crs(ell)
    vec_r = [rng.rand_g1() for _ in range(ell)]
    vec_s = [rng.rand_g1() for _ in range(ell)]
    instances, proofs = [], []
    t0 = time.perf_counter()
    with use_backend(HostBackend()) as hb:
        for _ in range(n_b):
            p_i = list(range(ell))
            rng.shuffle(p_i)
            k_i = rng.rand_fr()
            t_i = get_permutation(hb.batch_mul(vec_r, k_i), p_i)
            u_i = get_permutation(hb.batch_mul(vec_s, k_i), p_i)
            sigma_i = get_permutation(list(range(ell)), p_i)
            rb_i = generate_blinders(rng, 4)
            m_i = msm(crs.vec_G, sigma_i).add(msm(crs.vec_H, rb_i))
            instances.append(bv.ShuffleInstance(vec_r, vec_s, t_i, u_i, m_i))
            proofs.append(CurdleproofsProof.new(crs, vec_r, vec_s, t_i, u_i,
                                                m_i, p_i, k_i, rb_i, rng))
    gen_s = time.perf_counter() - t0
    swap = instances[n_b // 2]
    tampered = instances[:n_b // 2] + [bv.ShuffleInstance(
        swap.vec_S, swap.vec_R, swap.vec_T, swap.vec_U, swap.M)] \
        + instances[n_b // 2 + 1:]
    marks = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))

    batch_backend = TorchBackend()
    with use_backend(batch_backend):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        ok_s = bv.batch_verify(crs, instances, proofs, rng,
                               stream_chunk=BATCH_CHUNK, mark=mark)
        stream_ms = (time.perf_counter() - t0) * 1e3
        stats = dict(bv._batch_verify_streamed.last_stats)
        bad_s = bv.batch_verify(crs, tampered, proofs, rng,
                                stream_chunk=BATCH_CHUNK)
        t0 = time.perf_counter()
        ok_1 = bv.batch_verify(crs, instances, proofs, rng)
        one_ms = (time.perf_counter() - t0) * 1e3
        bad_1 = bv.batch_verify(crs, tampered, proofs, rng)
        counted(BATCH_PATH)
    if (ok_s, bad_s, ok_1, bad_1) != (True, False, True, False):
        raise AssertionError(f"batch verify verdicts: streamed {ok_s}/"
                             f"{bad_s}, one-MSM {ok_1}/{bad_1} (valid/"
                             f"tampered)")
    batch6 = (crs, instances, tampered, proofs)   # phase 9 (c) reuses it
    starts = [i for i, (s, _) in enumerate(marks) if s == "start"] \
        + [len(marks)]
    dispatches = [stage_ms(marks[a:b]) for a, b in zip(starts, starts[1:])]
    log(f"{BATCH_PATH}: streamed (chunk {BATCH_CHUNK}) accepted in "
        f"{stream_ms:.1f} ms, replay {stats['replay_s'] * 1e3:.1f} ms, split "
        f"{bv._batch_verify_streamed.last_split}, stats {json.dumps(stats)}, "
        f"tamper rejected; one-MSM accepted in {one_ms:.1f} ms, tamper "
        f"rejected; proofs made on the host in {gen_s:.1f} s; msm engines "
        + json.dumps(batch_backend.engine_counts))
    for i, st in enumerate(dispatches):
        log(f"  stream dispatch {i}: stages ms {json.dumps(st)}")

    # -- phase 7: the batched prover ------------------------------------------
    from curdleproofs_tpu_torch.host.g1 import G1
    from curdleproofs_tpu_torch.ops import msm_grouped as mg
    from curdleproofs_tpu_torch.ops.field import unpack_pairs
    from curdleproofs_tpu_torch.parallel import batch_prove as bp

    def prove_instances(crs, ell, count, seed):
        """`count` ProveInstances: one shared (R, S) from `seed` (the Whisk
        shuffle-relay shape, as the reference's batched-prover bench builds
        them), then per proof a permutation, k and blinders from its own
        RNG, seeded seed + 1 + i, which the prover draws on."""
        base = StdRng.seed_from_u64(seed)
        vr = [base.rand_g1() for _ in range(ell)]
        vs = [base.rand_g1() for _ in range(ell)]
        out = []
        with use_backend(HostBackend()) as hb:
            for i in range(count):
                g = StdRng.seed_from_u64(seed + 1 + i)
                p_i = list(range(ell))
                g.shuffle(p_i)
                k_i = g.rand_fr()
                rb_i = generate_blinders(g, 4)
                m_i = msm(crs.vec_G, get_permutation(list(range(ell)), p_i)) \
                    .add(msm(crs.vec_H, rb_i))
                out.append(bp.ProveInstance(
                    vr, vs, get_permutation(hb.batch_mul(vr, k_i), p_i),
                    get_permutation(hb.batch_mul(vs, k_i), p_i), m_i, p_i,
                    k_i, rb_i, g))
        return out

    def batch_run(path, crs, ell, count, seed, table, madd, n_check):
        """`batch_prove` of `count` instances on `TorchBackend()`, counted
        as `path`: the first `n_check` proofs' bytes against the port's
        sequential host prover on twins of their instances; per dispatch,
        each stage's device ms and kernel launches (CUDA events and launch
        counts at every `mark`)."""
        os.environ["CURDLEPROOFS_TABLE"] = "1" if table else "0"
        twins = prove_instances(crs, ell, n_check, seed)
        t0 = time.perf_counter()
        with use_backend(HostBackend()):
            want = [CurdleproofsProof.new(
                crs, i.vec_R, i.vec_S, i.vec_T, i.vec_U, i.M, i.permutation,
                i.k, i.vec_m_blinders, i.rng).serialize() for i in twins]
        host_ms = (time.perf_counter() - t0) * 1e3 / n_check
        t0 = time.perf_counter()
        insts = prove_instances(crs, ell, count, seed)
        gen_s = time.perf_counter() - t0
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev, dict(K.LAUNCHES)))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        with use_backend(TorchBackend()):
            proofs = bp.batch_prove(crs, insts, madd=madd, mark=mark)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted(path)
        del os.environ["CURDLEPROOFS_TABLE"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        unused = "g1_fold_madd" if not madd else "g1_fold_packed"
        if by_path[path][unused]:
            raise AssertionError(f"{path}: {unused} launched")
        if [p.serialize() for p in proofs[:n_check]] != want:
            raise AssertionError(f"{path}: proof bytes differ from the "
                                 f"sequential host prover")
        timings = dict(bp.batch_prove.last_timings)
        starts = [i for i, m in enumerate(marks) if m[0] == "start"] \
            + [len(marks)]
        per = []
        for a, b in zip(starts, starts[1:]):
            per.append({s1: {"ms": e0.elapsed_time(e1), "launches": {
                k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}}
                for (_, e0, n0), (s1, e1, n1) in zip(marks[a:b],
                                                     marks[a + 1:b])})
        if len(per) != timings["dispatches"]:
            raise AssertionError(f"{path}: {len(per)} marked dispatches, "
                                 f"{timings['dispatches']} timed")
        horner = [st.get("horner", {}).get("launches") for st in per]
        if any(h != {"g1_horner": 1} for h in horner) \
                or by_path[path]["g1_horner"] != len(per):
            raise AssertionError(f"{path}: the Horner stages launched "
                                 f"{horner}, not one g1_horner a dispatch")
        stage_sum = {}
        for st in per:
            for k, v in st.items():
                stage_sum[k] = stage_sum.get(k, 0.0) + v["ms"]
        log(f"{path}: {n_check} proofs equal the sequential host prover's "
            f"bytes; {count} proofs in {wall:.3f} s = {count / wall:.3f} "
            f"proofs/s ({wall * 1e3 / count:.2f} ms a proof) against "
            f"{host_ms:.2f} ms a proof on the host, sequential "
            f"({1e3 / host_ms:.3f} proofs/s); peak {peak:.3f} GiB; "
            f"instances made in {gen_s:.1f} s; timings "
            + json.dumps(timings))
        log(f"  stage ms summed over dispatches " + json.dumps(stage_sum))
        for i, st in enumerate(per):
            log(f"  dispatch {i}: " + json.dumps(st))
        return insts, proofs, per

    def shuffle_instances(insts):
        return [bv.ShuffleInstance(i.vec_R, i.vec_S, i.vec_T, i.vec_U, i.M)
                for i in insts]

    # (a) table mode at the reference's batched configuration; the proofs
    # batch-verify on the card, and one swapped instance fails the batch
    crs = generate_crs(PROVE_ELL)
    insts, proofs, _ = batch_run(TABLE_PATH, crs, PROVE_ELL, PROVE_B, 700,
                                 True, True, PROVE_CHECKED)
    shuffles = shuffle_instances(insts)
    swap = shuffles[PROVE_B // 3]
    bad = shuffles[:]
    bad[PROVE_B // 3] = bv.ShuffleInstance(swap.vec_S, swap.vec_R,
                                           swap.vec_T, swap.vec_U, swap.M)
    vrng = StdRng.seed_from_u64(701)
    with use_backend(TorchBackend()):
        t0 = time.perf_counter()
        ok = bv.batch_verify(crs, shuffles, proofs, vrng)
        verify_ms = (time.perf_counter() - t0) * 1e3
        rejected = not bv.batch_verify(crs, bad, proofs, vrng)
    if not ok or not rejected:
        raise AssertionError(f"{TABLE_PATH}: batch verify accepted {ok}, "
                             f"swapped instance rejected {rejected}")
    log(f"{TABLE_PATH}: all {PROVE_B} proofs batch-verify on the card in "
        f"{verify_ms:.1f} ms; a swapped instance is rejected")

    # the table path's kernels at its own shapes: the fold over the table
    # residency of this batch (one IPA round: 4 relations a proof, n/2 + 1
    # columns), its repack alone (the same launch with a plan of no rows),
    # g1_horner over a same-msm round's 6 B relations (window sums from that
    # fold, its 4 B relations' and the first 2 B's again), g1_add at the
    # table's multiples (d P + P), fq_mul at the table's prefix products'
    # [24, 7N]
    combined = list(crs.vec_G) + list(crs.vec_H) + [
        crs.H, crs.G_t, crs.G_u, G1.infinity()]
    for i in insts:
        combined += i.vec_R + i.vec_S + i.vec_T + i.vec_U
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = mg.DeviceBasesTable(md.DeviceBases(combined, dev))
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    text = (table.ext_px, table.ext_py, table.ext_zb)
    e_cnt = text[0].shape[1]
    n_rel, width = 4 * PROVE_B, (PROVE_ELL + 4) // 2 + 1
    rels = [([rnd.randrange(len(combined)) for _ in range(width)],
             [rnd.randrange(R) for _ in range(width)]) for _ in range(n_rel)]
    lt, ct = mg.upload_relations(
        *mg.pack_relations(rels, n_rel, width, table.n), dev)
    tplan = mg.table_plan(mg._digits(lt, n_rel, width), ct, table.n)
    t_rows, s_pad = tplan.shape
    tkinds = fold_row_kinds(*text, tplan)
    tfold_bytes = (2 * 48 + 4) * e_cnt + 4 * t_rows * s_pad + 3 * 96 * s_pad
    tacc = PointsXYZ(*check(
        "g1_fold_madd", f"table plan [{t_rows}, {s_pad}] over {e_cnt} "
        f"entries (an IPA round at l = {PROVE_ELL}, B = {PROVE_B})",
        lambda: K.g1_fold_madd(*text, tplan),
        lambda: K.g1_fold_madd_plain(*text, tplan), 3, tfold_bytes,
        tkinds["live"] * 11 * MUL32_PER_FQ_MUL))
    turns = {"fold": [], "repack": []}
    for what in ("fold", "repack", "repack", "fold"):
        rows_ = tplan if what == "fold" else tplan[:0]
        turns[what].append(event_ms(lambda: K.g1_fold_madd(*text, rows_),
                                    5)[1])
    repack_ms, fold_ms = (sum(turns[k]) / 2 for k in ("repack", "fold"))
    records["g1_fold_madd"]["table_repack"] = {
        "entries": e_cnt, "scratch_bytes": 4 * 24 * e_cnt,
        "turns": "fold, repack, repack, fold", "repack_ms": turns["repack"],
        "fold_ms": turns["fold"], "share": repack_ms / fold_ms,
        "table_build_ms": build_ms}
    log(f"table of {len(combined)} bases ({e_cnt} entries) built in "
        f"{build_ms:.1f} ms; in turns, the fold at [{t_rows}, {s_pad}] "
        f"{turns['fold']} ms, its repack alone (a plan of no rows) "
        f"{turns['repack']} ms: {100 * repack_ms / fold_ms:.1f}% of the "
        f"fold, in every dispatch")
    nh = HORNER_RELS[0]
    hws = tuple(torch.cat([c, c[:, :(nh - n_rel) * 64]], dim=1)
                .reshape(24, nh, 64) for c in tacc)
    horner_check(f"n_rel = {nh} (a same-msm round at l = {PROVE_ELL}, B = "
                 f"{PROVE_B}; window sums of the table fold)", hws)
    one7 = FQ.const(1, (1,), dev)
    hp, hq = (PointsXYZ(*(unpack_pairs(t[:, o:o + table.n]).int()
                          for t in text[:2]),
                        torch.where(text[2][o:o + table.n][None] != 0, one7,
                                    0).contiguous())
              for o in (table.n, 0))
    check("g1_add", f"N = {table.n} (the table's multiples: 2P + P over "
          f"its bases)", lambda: K.g1_add(hp, hq),
          lambda: K.g1_add_plain(hp, hq), 20, 9 * 96 * table.n,
          table.n * 12 * MUL32_PER_FQ_MUL)
    m7 = 7 * table.n
    za, zb = (unpack_pairs(t[:, table.n:table.n + m7]).int()
              for t in text[:2])
    check("fq_mul", f"[24, {m7}] (the table's prefix products)",
          lambda: (K.fq_mul(za, zb),), lambda: (K.fq_mul_plain(za, zb),), 20,
          3 * 96 * m7, m7 * MUL32_PER_FQ_MUL)
    del table, text, tplan, tacc, hws, hp, hq, za, zb, lt, ct, proofs
    del shuffles
    del bad, insts, combined

    # (b) slot mode with the full-add fold, every proof's bytes checked
    crs = generate_crs(SLOT_ELL)
    insts, _, per = batch_run(SLOT_PATH, crs, SLOT_ELL, SLOT_B, 800, False,
                              False, SLOT_B)
    scans = sum(st.get("merge", {}).get("launches", {}).get("g1_add", 0)
                for st in per)
    if scans == 0:
        raise AssertionError(f"{SLOT_PATH}: the merge made no g1_add scan "
                             f"launches")
    log(f"{SLOT_PATH}: {scans} g1_add scan launches in the merges")

    # the slot path's kernels at its shapes: one same-msm round (6 relations
    # a proof of n/2 columns) over this batch's resident bases: the full-add
    # fold on its slot plan, the suffix kernel's tree entry on its buckets
    combined = list(crs.vec_G) + list(crs.vec_H) + [
        crs.H, crs.G_t, crs.G_u, G1.infinity()]
    for i in insts:
        combined += i.vec_R + i.vec_S + i.vec_T + i.vec_U
    sb = md.DeviceBases(combined, dev)
    width = (SLOT_ELL + 4) // 2
    rels = [([rnd.randrange(len(combined)) for _ in range(width)],
             [rnd.randrange(R) for _ in range(width)])
            for _ in range(6 * SLOT_B)]
    sparams = mg.pick_grouped_params(len(rels), width, sb.n)
    lt, ct = mg.upload_relations(
        *mg.pack_relations(rels, sparams.n_rel, width, sb.n), dev)
    gp = mg.grouped_plan(mg._digits(lt, sparams.n_rel, width), ct, sparams)
    sext = (sb.ext_px, sb.ext_py, sb.ext_zb)
    skinds = fold_row_kinds(*sext, gp.plan)
    t_rows, s_pad = gp.plan.shape
    sacc = PointsXYZ(*check(
        "g1_fold_packed", f"slot plan [{t_rows}, {s_pad}] over "
        f"{sext[0].shape[1]} entries (a same-msm round at l = {SLOT_ELL}, "
        f"B = {SLOT_B})", lambda: K.g1_fold_packed(*sext, gp.plan),
        lambda: K.g1_fold_packed_plain(*sext, gp.plan), 5,
        (2 * 48 + 4) * sext[0].shape[1] + 4 * t_rows * s_pad
        + 3 * 96 * s_pad, skinds["products"] * MUL32_PER_FQ_MUL))
    sacc = md._suffix_scan(sacc, gp.slot_gkey, gp.kmax)
    one_m = FQ.const(1, (1, 1), dev)
    sd = PointsXYZ(torch.where(gp.occ, sacc.x[:, gp.sel], 0),
                   torch.where(gp.occ, sacc.y[:, gp.sel], one_m),
                   torch.where(gp.occ, sacc.z[:, gp.sel], 0))
    cb7, wg7 = sd.x.shape[1:]
    swsum = check("g1_suffix_weighted_tree", f"Cb = {cb7}, WG = {wg7} (the "
                  f"c = 4 reduction of that round)",
                  lambda: sum(K.g1_suffix_weighted_tree(*sd), ()),
                  lambda: sum(K.g1_suffix_weighted_tree_plain(*sd), ()), 20,
                  *suffix_cost(cb7, wg7))[3:]
    horner_check(f"n_rel = {sparams.n_rel} (that round's window sums)",
                 tuple(c.reshape(24, sparams.n_rel, 64) for c in swsum))
    del sb, sext, gp, sacc, sd, swsum, lt, ct, insts, combined

    # -- phase 8: the reference's other backends ------------------------------
    from curdleproofs_tpu_torch.ops import msm as ladders
    from curdleproofs_tpu_torch.ops import msm_tune
    from curdleproofs_tpu_torch.ops.backend import DeviceBackend, HybridBackend
    from curdleproofs_tpu_torch.ops.limbs import ints_to_bits
    from curdleproofs_tpu_torch.tools.msm_autotune import tune

    # (a) the ladder kernel's three entries against the plain version after
    # affine normalization at the grand product's widths (l = 124, 252) and
    # at 2^16, the plain version run once an entry and width.  The wrapper
    # gets the words on the host, as `ops/msm.py` passes them, so `ms`
    # includes the GLV split on the host and the halves' upload;
    # `kernel_ms` times `ladder_launch` alone on halves already on the
    # card.  The bound counts the 32-bit multiplies the kernel's GLV chains
    # need on these scalars (`glv_mul32`): two tables (P's and phi(P)'s: a
    # doubling, 6 products and 2 squarings, and six adds of 12 products
    # each), phi's product on P, in each half four doublings a window below
    # the highest nonzero digit of either half and an add a nonzero digit
    # but the first (which lands on infinity), the join where both halves
    # hold one, and the fold's add.  The count for the 255-step ladder of
    # the kernel's first design (`ladder_mul32`: a doubling a step below
    # the top set bit, an add a set bit below it) stays beside it as
    # `old_bound_ms`.
    dbl32 = 6 * MUL32_PER_FQ_MUL + 2 * MUL32_PER_FQ_SQR
    add32 = 12 * MUL32_PER_FQ_MUL

    def ladder_mul32(k: int) -> int:
        steps = max(k.bit_length() - 1, 0)
        adds = max(bin(k).count("1") - 1, 0)
        return steps * dbl32 + adds * add32

    def glv_digits(halves) -> np.ndarray:
        """The kernel's digits of `glv_split`'s halves ([2, 5] or [2, 5,
        N]) on the host: [2, N, 33], digit j = b(4j-1) + b(4j) + 2 b(4j+1)
        + 4 b(4j+2) - 8 b(4j+3) of the magnitude (b(-1) = 0), negated for
        a negative half (only whether a digit is 0 counts here)."""
        w = halves.cpu().numpy().view(np.uint32).reshape(2, K.GLV_HALF_WORDS,
                                                         -1)
        mag = w.copy()
        mag[:, -1] &= 0x7FFFFFFF
        le = np.ascontiguousarray(mag.transpose(0, 2, 1)).view(np.uint8)
        bits = np.unpackbits(le, axis=2, bitorder="little").astype(np.int8)
        b = np.zeros(bits.shape[:2] + (4 * K.GLV_WINDOWS + 1,), np.int8)
        b[:, :, 1:] = bits[:, :, :4 * K.GLV_WINDOWS]       # b[i + 1] = b(i)
        d = (b[:, :, 0:-1:4] + b[:, :, 1::4] + 2 * b[:, :, 2::4]
             + 4 * b[:, :, 3::4] - 8 * b[:, :, 4::4])
        return np.where((w[:, -1] >> 31)[:, :, None] != 0, -d, d)

    def glv_mul32(halves) -> int:
        nz = glv_digits(halves) != 0                        # [2, n, 33]
        either = nz[0] | nz[1]
        top = np.where(either.any(axis=1),
                       K.GLV_WINDOWS - 1 - np.argmax(either[:, ::-1], axis=1),
                       0)
        adds = np.maximum(nz.sum(axis=2) - 1, 0).sum()
        joins = (nz[0].any(axis=1) & nz[1].any(axis=1)).sum()
        return int(nz.shape[1] * (2 * (dbl32 + 6 * add32) + MUL32_PER_FQ_MUL)
                   + 2 * 4 * dbl32 * top.sum() + add32 * (adds + joins))

    for n in (124, 252, N_SMALL):
        pl = points_to_device(tiled(n, 17), dev)
        left = points_to_device(tiled(n, 5), dev)
        k, gamma = rnd.randrange(R), rnd.randrange(R)
        each = [rnd.randrange(R) for _ in range(n)]
        reps = 20 if n < N_SMALL else 3
        for entry, ks, lf in (("batch_mul", [k], None),
                              ("batch_mul_each", each, None),
                              ("fold", [gamma], left)):
            bits = ints_to_bits(ks, ladders.NBITS)
            per_point = len(ks) > 1
            words = ladders.scalar_words(bits if per_point else bits[0],
                                         "cpu", per_point)
            halves = K.glv_split(words).to(dev)
            scale = 1 if per_point else n
            mul32 = scale * glv_mul32(halves) + (n * add32 if lf else 0)
            old32 = scale * sum(ladder_mul32(s) for s in ks) \
                + (n * add32 if lf else 0)
            nbytes = (6 if lf else 3) * 96 * n + 3 * 96 * n \
                + 4 * halves.numel()
            check("g1_ladder", f"{entry}, n = {n}",
                  lambda: K.g1_ladder(pl, words, lf),
                  lambda: K.g1_ladder_plain(pl, words.to(dev), lf),
                  reps, nbytes, mul32, affine=True)
            at = records["g1_ladder"]
            at = at["more_shapes"][-1] if at["more_shapes"] else at
            at["kernel_ms"] = event_ms(lambda: K.ladder_launch(pl, halves, lf),
                                       reps)[1]
            at["old_bound_ms"] = bound(nbytes, old32)[0]
            log(f"  g1_ladder {entry}, n = {n}: kernel "
                f"{at['kernel_ms']:.4f} ms; old bound "
                f"{at['old_bound_ms']:.4f} ms")
    with_ptxas("g1_ladder", "g1_ladder_kernel")   # every entry
    del pl, left, halves

    # (b) the all-device backend (CURDLEPROOFS_BACKEND=tpu): phase 4's run,
    # the ladder on the path
    dbackend = DeviceBackend()
    prove_walls["DeviceBackend"] = protocol_run(dbackend, "DeviceBackend")
    counted(DEVICE_PATH)
    log(f"msm engines on {DEVICE_PATH}: "
        + json.dumps(dbackend.engine_counts))

    # (c) the autotuner into a table of its own, then HybridBackend untuned
    # and on that table: every MSM where `route_to_device` (or, untuned,
    # the reference's fallback) puts it
    routes = []
    route = msm_tune.route_to_device

    def traced_route(n, resident, device="cuda"):
        v = route(n, resident, device)
        routes.append((n, resident, v))
        return v

    msm_tune.route_to_device = traced_route
    with tempfile.TemporaryDirectory() as tmp:
        for label, path in (("HybridBackend untuned", HYBRID_UNTUNED),
                            ("HybridBackend tuned", HYBRID_TUNED)):
            table = pathlib.Path(tmp) / "msm_tune.json"
            os.environ["CURDLEPROOFS_TUNE"] = str(table)
            msm_tune._load_raw.cache_clear()
            if path == HYBRID_TUNED:
                t0 = time.perf_counter()
                tuned = tune(TUNE_LOGNS, dev, log=log)
                log(f"autotuner at 2^{TUNE_LOGNS}: every MSM equal to the "
                    f"host's, {time.perf_counter() - t0:.1f} s; table "
                    + table.read_text().replace("\n", " "))
                if sorted(tuned) != [1 << e for e in TUNE_LOGNS] or \
                        set(msm_tune.load_table(dev)) != set(tuned):
                    raise AssertionError("the autotuner's table misses a "
                                         "family")
            routes.clear()
            hbackend = HybridBackend()
            prove_walls[label] = protocol_run(hbackend, label)
            counted(path)
            to_dev = sum(1 for _, _, v in routes if v)
            verdicts = {v for _, _, v in routes}
            log(f"{label}: msm engines {json.dumps(hbackend.engine_counts)}; "
                f"{len(routes)} routing verdicts, {to_dev} to the card")
            if path == HYBRID_UNTUNED and (
                    verdicts - {None} or hbackend.engine_counts["device"]
                    or any(by_path[path].values())):
                raise AssertionError(f"{label}: an MSM or a kernel reached "
                                     f"the card")
            if path == HYBRID_TUNED and (
                    None in verdicts
                    or hbackend.engine_counts != {
                        "device": to_dev, "host": len(routes) - to_dev}):
                raise AssertionError(f"{label}: engine counts "
                                     f"{hbackend.engine_counts} do not follow "
                                     f"the table's verdicts {routes}")
        del os.environ["CURDLEPROOFS_TUNE"]
        msm_tune._load_raw.cache_clear()
    msm_tune.route_to_device = route
    log("prove and verify walls (ms) by backend: " + json.dumps(prove_walls))

    # (d) the CLI round trip in subprocesses, under hybrid and tpu
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        trng = StdRng.seed_from_u64(5)
        trk = [WhiskTracker.from_rand(trng) for _ in range(WHISK_ELL)]
        (d / "pre.json").write_text(json.dumps(
            [{"r_G": "0x" + t.r_G.hex(), "k_r_G": "0x" + t.k_r_G.hex()}
             for t in trk]))

        def cli(backend_name, *args):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "curdleproofs_tpu_torch", *args],
                cwd=ROOT, capture_output=True, text=True, timeout=600,
                env={**os.environ, "CURDLEPROOFS_BACKEND": backend_name})
            return r, (time.perf_counter() - t0) * 1e3

        r, _ = cli("host", "crs", "--ell", str(WHISK_ELL), "-o",
                   str(d / "crs.json"))
        if r.returncode:
            raise AssertionError(f"cli crs failed: {r.stderr[-2000:]}")
        files = ["--crs", str(d / "crs.json"), "--pre", str(d / "pre.json"),
                 "--post", str(d / "post.json"), "--proof", str(d / "p.bin")]
        for name in ("hybrid", "tpu"):
            rp, prove_s = cli(name, "shuffle-prove", *files, "--seed", "7")
            rv, verify_s = cli(name, "shuffle-verify", *files)
            if rp.returncode or rv.returncode or "valid" not in rv.stdout:
                raise AssertionError(f"cli round trip under {name}: "
                                     f"{rp.stderr[-2000:]}{rv.stderr[-2000:]}")
            log(f"cli under CURDLEPROOFS_BACKEND={name}: shuffle-prove "
                f"{prove_s:.0f} ms, shuffle-verify {verify_s:.0f} ms "
                f"(processes): {rv.stdout.strip()}")
        r, _ = cli("tpu", "info")
        info = json.loads(r.stdout) if r.returncode == 0 else {}
        if info.get("device") != kind or "g1_ladder" not in info.get(
                "kernels_built", ()):
            raise AssertionError(f"cli info: {r.stdout}{r.stderr[-2000:]}")
        log("cli info: " + json.dumps(info))

    # -- phase 9: multi-device on one card -------------------------------------
    from curdleproofs_tpu_torch.parallel import distributed as pdist
    from curdleproofs_tpu_torch.parallel import sharded_msm as psm
    from curdleproofs_tpu_torch.tools.multihost_verify import build_batch

    def grid(dp, dw):
        """A (Dp, Dw) logical grid: every cell is cuda:0."""
        mesh = psm.make_msm_mesh(dp * dw, dw, devices=[dev] * (dp * dw))
        if mesh.devices.shape != (dp, dw):
            raise AssertionError(f"grid {mesh.devices.shape}, not {(dp, dw)}")
        return mesh

    log(f"[{card}] phase 9: the sharded MSM on logical grids over cuda:0, "
        f"one card, logical grid: every cell is the one card and the cells "
        f"run one after another, so these times show what sharding costs "
        f"on one card, not how it scales")

    # the kernels at the shapes a window shard hands them: the suffix kernel
    # at a (4, 2) grid's (Cb, WG), c = 16 (626k) and c = 8, the chunk
    # suffix's scan step over that W*G, the reduce's g1_add and
    # leave-Montgomery's fq_mul over Wl window sums
    gz = K.g1_add_plain(points_to_device(tiled(4096, 1), dev),
                        points_to_device(tiled(4096, 2), dev))
    for c9, dw9 in ((16, 2), (8, 2)):
        wl = -(-255 // c9) // dw9
        g9, cb9 = md._phase3_chunks(c9, wl)
        wg9 = wl * g9
        idx = torch.arange(cb9 * wg9, device=dev) % 4096
        rows9 = [c[:, idx].reshape(24, cb9, wg9) for c in gz]
        what = f"a cell of the c = {c9} MSM on a (4, {dw9}) grid"
        entry = "g1_suffix_weighted_tree" if K.suffix_uses_tree(cb9, wg9) \
            else "g1_suffix_weighted"
        plain = K.g1_suffix_weighted_tree_plain if entry.endswith("tree") \
            else K.g1_suffix_weighted_plain
        check(entry, f"Cb = {cb9}, WG = {wg9} ({what})",
              lambda: sum(K.g1_suffix_weighted(*rows9), ()),
              lambda: sum(plain(*rows9), ()), 5, *suffix_cost(cb9, wg9))
        scan_check(f"scan step, W*G = {wg9} (G = {g9}, {what})",
                   PointsXYZ(*(c[:, idx[:wg9]] for c in gz)),
                   torch.arange(wg9, device=dev) // g9, 1, 20)
        p9, q9 = (PointsXYZ(*(c[:, o:o + wl].contiguous() for c in gz))
                  for o in (0, wl))
        check("g1_add", f"N = {wl} (a reduce step over {what}'s window "
              f"sums)", lambda: K.g1_add(p9, q9),
              lambda: K.g1_add_plain(p9, q9), 50, 9 * 96 * wl,
              wl * 12 * MUL32_PER_FQ_MUL)
        lm9 = torch.cat(tuple(p9), dim=1)
        check("fq_mul", f"leave-Montgomery [24, 3Wl = {3 * wl}] x [24, 1] "
              f"({what})", lambda: (K.fq_mul(lm9, one_plain),),
              lambda: (K.fq_mul_plain(lm9, one_plain),), 50,
              2 * 96 * 3 * wl + 96, 3 * wl * MUL32_PER_FQ_MUL)
    del gz, rows9, p9, q9, lm9, idx

    def sharded_run(mesh, pts, ss, want, label) -> dict:
        """One `sharded_msm_kernel` call with CUDA events (and the host
        clock) at every mark: per cell each stage's device ms, the
        points-axis reduce's device ms, the download's and the host
        combine's ms, the wall and the peak memory.  The result must equal `want`."""
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev, time.perf_counter()))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mark("begin")
        got = psm.sharded_msm_kernel(mesh, len(pts))(pts, ss, mark=mark)
        wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError(f"{label}: the sharded MSM differs from the "
                                 f"host MSM")
        cells, rest = {}, {}
        for (_, e0, h0), (s1, e1, h1) in zip(marks, marks[1:]):
            head, _, stage = s1.partition(" ")
            if "," in head:
                if stage != "start":
                    cells.setdefault(head, {})[stage] = e0.elapsed_time(e1)
            elif s1 == "reduce":
                rest["reduce_ms"] = e0.elapsed_time(e1)
            else:                      # download, combine: the host's clock
                rest[f"{s1}_ms"] = (h1 - h0) * 1e3
        rec = {"wall_ms": wall, **rest,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "cells": cells}
        log(f"[{card}] {label}: equal to the host MSM; one card, logical "
            f"grid: wall {wall:.1f} ms, " + json.dumps(rest)
            + f", peak {rec['peak_gib']:.3f} GiB")
        for cell, st in cells.items():
            log(f"  cell {cell}: {sum(st.values()):.3f} device ms, stages "
                + json.dumps({k: round(v, 3) for k, v in st.items()}))
        return rec

    # (a) every grid shape at n = 64, a ragged n = 37, then the 626k MSM
    rng9 = StdRng.seed_from_u64(900)
    pts64 = [rng9.rand_g1() for _ in range(64)]
    ss64 = [rnd.randrange(R) for _ in range(64)]
    want64 = host.msm(pts64, ss64)
    want37 = host.msm(pts64[:37], ss64[:37])
    torch.cuda.synchronize()
    K.reset_launches()
    for dp9, dw9 in SHARD_GRIDS:
        t0 = time.perf_counter()
        got = psm.sharded_msm(pts64, ss64, grid(dp9, dw9))
        ms = (time.perf_counter() - t0) * 1e3
        if got != want64:
            raise AssertionError(f"sharded MSM n=64 on ({dp9}, {dw9}) "
                                 f"differs from the host MSM")
        log(f"[{card}] sharded MSM n=64 on a ({dp9}, {dw9}) logical grid: "
            f"equal to the host MSM, wall {ms:.1f} ms")
    if psm.sharded_msm(pts64[:37], ss64[:37], grid(8, 1)) != want37:
        raise AssertionError("sharded MSM n=37 on (8, 1) differs from the "
                             "host MSM")
    log(f"[{card}] sharded MSM n=37 (ragged) on an (8, 1) logical grid: "
        f"equal to the host MSM")
    shard_big = {}
    for dp9, dw9 in SHARD_BIG_GRIDS:
        shard_big[f"{dp9}x{dw9}"] = sharded_run(
            grid(dp9, dw9), big_pts, big_ss, host_want[BIG_PATH],
            f"sharded MSM n={N_BIG} on a ({dp9}, {dw9}) logical grid")
    counted(SHARD_PATH)
    if by_path[SHARD_PATH]["g1_sqrt"]:
        raise AssertionError(f"{SHARD_PATH}: g1_sqrt launched on plain "
                             f"uploads")
    # the unsharded MSM on the same inputs: fresh (compressed upload), then
    # resident
    for what in ("fresh bases", "resident bases"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = md.msm_device(big_pts, big_ss, device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        if got != host_want[BIG_PATH]:
            raise AssertionError("msm_device n=626k differs from the host")
        shard_big[f"unsharded msm_device, {what}"] = {"wall_ms": ms}
        log(f"[{card}] unsharded msm_device n={N_BIG}, {what}: wall "
            f"{ms:.1f} ms, beside the logical grids' walls above")
    md._BASES_CACHE.clear()

    # (b) the full-add fold through CURDLEPROOFS_MADD=0
    os.environ["CURDLEPROOFS_MADD"] = "0"
    K.reset_launches()
    got = psm.sharded_msm(pts64, ss64, grid(4, 2))
    counted(SHARD_FULL_ADD_PATH)
    del os.environ["CURDLEPROOFS_MADD"]
    if got != want64 or by_path[SHARD_FULL_ADD_PATH]["g1_fold_madd"] \
            or by_path[SHARD_FULL_ADD_PATH]["g1_sqrt"]:
        raise AssertionError(f"{SHARD_FULL_ADD_PATH}: wrong result, or the "
                             f"madd fold or g1_sqrt launched")

    # (c) phase 6's batch verified with its deduped MSM on a (4, 2) grid
    # (the replays on the host): the one-MSM verdicts
    crs6, inst6, bad6, proofs6 = batch6
    mesh42 = grid(4, 2)
    with use_backend(HostBackend()):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        ok_m = bv.batch_verify(crs6, inst6, proofs6, StdRng.seed_from_u64(9),
                               mesh=mesh42)
        mesh_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        bad_m = bv.batch_verify(crs6, bad6, proofs6, StdRng.seed_from_u64(9),
                                mesh=mesh42)
        mesh_bad_ms = (time.perf_counter() - t0) * 1e3
        counted(MESH_BATCH_PATH)
    if (ok_m, bad_m) != (ok_1, bad_1) or by_path[MESH_BATCH_PATH]["g1_sqrt"]:
        raise AssertionError(f"{MESH_BATCH_PATH}: verdicts {ok_m}/{bad_m}, "
                             f"the one-MSM run's {ok_1}/{bad_1}")
    log(f"[{card}] {MESH_BATCH_PATH}: accepted in {mesh_ms:.1f} ms, the "
        f"swapped instance rejected in {mesh_bad_ms:.1f} ms (one card, "
        f"logical grid; the replays on the host), as the one-MSM run")
    del batch6, crs6, inst6, bad6, proofs6

    # (d) the protocol through the grid: every MSM of 8 or more terms
    class MeshBackend(TorchBackend):
        """Every MSM of 8 or more terms through `sharded_msm` on `mesh`,
        the rest and the latency ops on the host; the fused native loops
        off, so every folding round's MSM crosses the grid."""

        name = "mesh"

        def __init__(self, mesh):
            super().__init__(dev)
            self.mesh = mesh

        def msm(self, points, scalars):
            if not points:
                return G1.infinity()
            if not self._on_device(points):
                return self._host.msm(points, scalars)
            return psm.sharded_msm(points, list(scalars), self.mesh)

        def msm_raw(self, points, sbytes):
            if len(sbytes) != 32 * len(points):
                raise ValueError("scalar buffer and points differ in length")
            if not points:
                return G1.infinity()
            if not self._on_device(points):
                return self._host.msm_raw(points, sbytes)
            return psm.sharded_msm(points, bytes(sbytes), self.mesh)

    mesh_backend = MeshBackend(mesh42)
    ell12 = 12
    crs12 = generate_crs(ell12)

    def build12(seed):
        g = StdRng.seed_from_u64(seed)
        vr = [g.rand_g1() for _ in range(ell12)]
        vs = [g.rand_g1() for _ in range(ell12)]
        perm = list(range(ell12))
        g.shuffle(perm)
        k = g.rand_fr()
        T, U, M, mb = shuffle_permute_and_commit_input(crs12, vr, vs, perm,
                                                       k, g)
        return CurdleproofsProof.new(crs12, vr, vs, T, U, M, perm, k, mb, g), \
            bv.ShuffleInstance(vr, vs, T, U, M)

    with use_backend(HostBackend()):
        built = [build12(seed) for seed in (3, 4)]
    proofs12 = [p for p, _ in built]
    insts12 = [i for _, i in built]
    bad12 = [insts12[0], bv.ShuffleInstance(
        insts12[1].vec_S, insts12[1].vec_R, insts12[1].vec_T,
        insts12[1].vec_U, insts12[1].M)]
    with use_backend(mesh_backend):
        rng = StdRng.seed_from_u64(0)
        crs = CurdleproofsCrs.generate_crs(WHISK_ELL)
        pre = [WhiskTracker.from_rand(rng) for _ in range(WHISK_ELL)]
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        post, proof = generate_whisk_shuffle_proof(rng, crs, pre)
        mesh_prove_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ok = is_valid_whisk_shuffle_proof(rng, crs, pre, post, proof)
        mesh_verify_ms = (time.perf_counter() - t0) * 1e3
        tampered = [WhiskTracker.from_rand(StdRng.seed_from_u64(9))] \
            + post[1:]
        rejected = not is_valid_whisk_shuffle_proof(rng, crs, pre, tampered,
                                                    proof)
        vrng = StdRng.seed_from_u64(9)
        ok12 = bv.batch_verify(crs12, insts12, proofs12, vrng, mesh=mesh42)
        bad12_ok = bv.batch_verify(crs12, bad12, proofs12, vrng, mesh=mesh42)
        counted(MESH_PROTOCOL_PATH)
    if proof.hex() != golden or len(proof) != 4496:
        raise AssertionError("the l=124 whisk proof through the grid differs "
                             "from the golden vector")
    if not ok or not rejected or ok12 is not True or bad12_ok is not False:
        raise AssertionError(f"{MESH_PROTOCOL_PATH}: verify {ok}, tamper "
                             f"rejected {rejected}, mesh batch verify "
                             f"{ok12}/{bad12_ok}")
    log(f"[{card}] {MESH_PROTOCOL_PATH}: proof equals the golden 4496 bytes; "
        f"prove {mesh_prove_ms:.1f} ms, verify {mesh_verify_ms:.1f} ms, "
        f"tamper rejected; mesh batch_verify (l = {ell12}, 2 proofs) "
        f"accepts and rejects a swapped instance; msm engines "
        + json.dumps(mesh_backend.engine_counts))

    # (e) two gloo processes on the one card, then a single-process
    # distributed verification with a (2, 1) grid
    with tempfile.TemporaryDirectory() as tmp:
        art_path = pathlib.Path(tmp) / "multihost.json"
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(ROOT / "curdleproofs_tpu_torch" / "tools"
                                 / "multihost_verify.py"),
             "--out", str(art_path)],
            cwd=ROOT, capture_output=True, text=True, timeout=450,
            env={**os.environ, "CURDLEPROOFS_BACKEND": "torch"})
        mh_s = time.perf_counter() - t0
        if r.returncode:
            raise AssertionError(f"the two-rank run failed: "
                                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        art = json.loads(art_path.read_text())
    ranks = {w["rank"]: w for w in art["workers"]}
    if not (art["ok"] is True and set(ranks) == {0, 1}
            and all(w["process_count"] == 2 and w["backend"] == "torch"
                    for w in ranks.values())
            and ranks[0]["valid_pass"] and ranks[1]["valid_pass"]
            and ranks[0]["local_ok_corrupt"]
            and not ranks[1]["local_ok_corrupt"]
            and not ranks[0]["corrupt_pass"]
            and not ranks[1]["corrupt_pass"]):
        raise AssertionError(f"two-rank verdicts: {json.dumps(art)}")
    log(f"[{card}] two gloo ranks on cuda:0 (CURDLEPROOFS_BACKEND=torch): "
        f"valid pass True on both, corrupt pass False on both (rank 1's "
        f"slice rejected locally), {mh_s:.1f} s with process start; "
        + json.dumps(art))
    with use_backend(HostBackend()):
        crs_m, inst_m, proofs_m = build_batch()
        rank, world = pdist.init_multihost()
        mesh21 = grid(2, 1)
        t0 = time.perf_counter()
        ok_d = pdist.distributed_batch_verify(
            crs_m, inst_m, proofs_m, StdRng.seed_from_u64(99),
            local_mesh=mesh21)
        dist_ms = (time.perf_counter() - t0) * 1e3
        last = inst_m[-1]
        inst_m[-1] = bv.ShuffleInstance(last.vec_R, last.vec_S, last.vec_U,
                                        last.vec_T, last.M)
        bad_d = pdist.distributed_batch_verify(
            crs_m, inst_m, proofs_m, StdRng.seed_from_u64(99),
            local_mesh=mesh21)
    if (rank, world, ok_d, bad_d) != (0, 1, True, False):
        raise AssertionError(f"single-process distributed verify: rank "
                             f"{rank}/{world}, verdicts {ok_d}/{bad_d}")
    log(f"[{card}] distributed_batch_verify, one process, (2, 1) grid: "
        f"accepted in {dist_ms:.1f} ms, a T/U swap rejected")
    log("phase 9 record: " + json.dumps({"card": card, "msm_626k": shard_big}))

    # -- phase 10: cold start from the kernel store ----------------------------
    cold = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, bg, extra in (("store hit", "0", []),
                                 ("store hit, background init", "1", []),
                                 ("first launches", "0", ["--first-launch"])):
            out = pathlib.Path(tmp) / f"cold{len(cold)}.json"
            logn = "10" if extra else str(COLD_LOGN)
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, str(TOOLS / "cold_start_probe.py"), logn,
                 "--out", str(out), *extra], cwd=ROOT, capture_output=True,
                text=True, timeout=300,
                env={**os.environ, "CURDLEPROOFS_BG_INIT": bg})
            wall = time.perf_counter() - t0
            if r.returncode:
                raise AssertionError(f"cold start probe ({label}) failed: "
                                     f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
            art = json.loads(out.read_text())
            if art["aot_hit"] is not True or art["built_s"] != 0 \
                    or art["match"] is not True \
                    or (bg == "1" and ("init_s" not in art["bg_init"]
                                       or "error" in art["bg_init"])):
                raise AssertionError(f"cold start probe ({label}): "
                                     + json.dumps(art))
            cold[label] = {**art, "process_wall_s": wall}
    split = {"store miss (phase 2)": {
        "export_s": export_s,
        "nvcc_s": {s: r["build_s"] for s, r in exported.items()}}}
    split.update({label: {k: v for k, v in art.items()
                          if k.endswith("_s") or k in (
                              "aot_hit", "lib_load_ms", "first_launch_ms",
                              "bg_init")}
                  for label, art in cold.items()})
    log(f"[{card}] phase 10, cold start: a fresh process on a kernel store "
        f"hit runs no nvcc and its first MSM equals the host's; split "
        + json.dumps(split))
    lib_load = cold["first launches"]["lib_load_ms"]
    first_launch = cold["first launches"]["first_launch_ms"]

    # -- phase 11: the measurement tools, each once at a small size -----------
    from curdleproofs_tpu_torch.tools import (
        aot_export, batch_prove_bench, grouped_profile, msm_profile,
        msm_sweep, multihost_scaling, scaling_report, speed_of_light,
        sync_floor_probe,
    )

    tool_runs = (
        (aot_export, [], {"sources", "built_s", "store"}),
        (msm_sweep, ["10", "11", "12", "--big", str(N_BIG),
                     "--proxy-logn", "12"], {"rows", "big", "shard_proxy"}),
        (msm_profile, ["12"], {"results", "stage_map"}),
        (grouped_profile, ["256", "128", "--bases", "32768", "--reps", "2"],
         {"modes", "table_ms"}),
        (batch_prove_bench, ["4", "28"], {"cold_s", "warm_s", "gates"}),
        (sync_floor_probe, [], {"sync_floor_ms", "prover_device_floor_ms",
                                "host_prove_ms"}),
        (speed_of_light, [], {"fq_mul_per_s", "g1_add_per_s",
                              "fq_mul_pct_of_sol", "g1_add_pct_of_sol"}),
        (scaling_report, [], {"rows"}),
        (multihost_scaling, ["8", "28", "--rounds", "2"],
         {"single_host", "per_host_isolated", "live_world2"}),
    )
    tools_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mod, argv, keys in tool_runs:
            name = mod.__name__.rsplit(".", 1)[1]
            out = pathlib.Path(tmp) / f"{name}.json"
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):  # its artifact
                rc = mod.main([*argv, "--out", str(out)])
            wall = time.perf_counter() - t0
            art = json.loads(out.read_text())
            st = art.get("stamps", {})
            if rc != 0 or art.get("match") is not True \
                    or not keys <= set(art) or st.get("card") != card \
                    or not st.get("commit") or len(st.get("source_sha256",
                                                           "")) != 64 \
                    or st.get("torch") != torch.__version__:
                raise AssertionError(f"tool {name} (rc {rc}): "
                                     + json.dumps(art)[:4000])
            tools_out[name] = {"wall_s": wall, **{k: art[k] for k in keys}}
            log(f"[{card}] tool {name} {' '.join(argv)}: equal to the host, "
                f"stamped, {wall:.1f} s")
    if any(r["built"] for r in tools_out["aot_export"]["sources"].values()):
        raise AssertionError("aot_export rebuilt a stored library")
    log("phase 11 record: " + json.dumps({"card": card, "tools": tools_out}))

    for name, rec in records.items():
        src = K.source_of(name)
        rec["build_s"] = exported[src]["build_s"]
        rec["cold_lib_load_ms"] = {e: lib_load[e] for e in K.ENTRIES[src]}
        rec["cold_first_launch_ms"] = {
            e: ms for e, ms in first_launch.items()
            if e.split()[0] in K.ENTRIES[src]}
        path = OWN_PATH.get(name, MAIN_PATH)
        rec["launches"] = by_path[path][name]
        rec["launches_path"] = ("kernel check only (no caller in the JAX "
                                "package)") if name in NO_CALLER else path
        rec["launches_by_path"] = {p: v[name] for p, v in by_path.items()}

    print(json.dumps({"kernels": [records[k] for k in K.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # an empty kernel store of this run's own: phase 2 builds into it (a
    # miss), phase 10's fresh processes load from it (hits)
    with tempfile.TemporaryDirectory(prefix="curdleproofs_aot_") as store:
        os.environ["CURDLEPROOFS_AOT_DIR"] = store
        sys.exit(main())
