"""Build every kernel library into the kernel store (`ops/aot.py`), so that
later processes load them and run no nvcc (the JAX package's
`scripts/aot_export.py`).

    python3 curdleproofs_tpu_torch/tools/aot_export.py --out PATH

The store is `CURDLEPROOFS_AOT_DIR` (default: `curdleproofs_aot` in the
temporary directory); with `CURDLEPROOFS_AOT=0`, the tree's `_build/cuda/`.
A source already stored for this tree and toolkit is kept (delete the
store's directory to build it again).  The artifact lists each source:
stored or built by this run, the library's size and key, and nvcc's
seconds (the stored ones' from the run that built them), with the
export's wall.  The reference's second
script, `warm_cache.py`, has no counterpart: CUDA has one compile step,
where XLA lowers and then compiles.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    args = ap.parse_args(argv)
    device = common.device_of(args)
    from curdleproofs_tpu_torch.ops import aot

    t0 = time.perf_counter()
    recs = aot.export(log=lambda s: print(s, flush=True))
    wall = time.perf_counter() - t0
    art = {
        "tool": "aot_export", "store": str(aot.store_dir()),
        "enabled": aot.enabled(), "wall_s": wall,
        "built_s": sum(r["build_s"] for r in recs.values() if r["built"]),
        "sources": {s: {k: r[k] for k in ("built", "bytes", "build_s", "key",
                                          "toolkit")}
                    for s, r in recs.items()},
        "match": sorted(recs) == sorted(aot.SOURCES),
    }
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
