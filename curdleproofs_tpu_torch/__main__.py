"""The port's command line: `python -m curdleproofs_tpu_torch <command>`.

The JAX package's CLI (`python -m curdleproofs_tpu`) on the port: CRS
files, whisk shuffle proofs and tracker opening proofs over files, with the
same byte formats (whisk.rs:21-25 sizes, crs.rs:77-142 hex-JSON), so
artifacts interoperate with the reference's and with arkworks-serialized
ones.  The backend comes from `CURDLEPROOFS_BACKEND` (`torch`, the
default, `hybrid`, `tpu` and `auto` run on the card and raise without one;
`host` and `pure` run on the CPU).

Commands:
  crs                   generate a (dev, seeded) CRS -> hex-JSON file
  shuffle-prove         shuffle + prove over a tracker-list JSON
  shuffle-verify        verify a whisk shuffle proof (exit 0 valid / 1 not)
  shuffle-verify-batch  verify a manifest of shuffles with one MSM
  tracker-prove         Schnorr DLEQ opening proof for one tracker
  tracker-verify        verify a tracker opening proof
  info                  backend / torch / card / kernels / native runtime

Tracker-list JSON: [{"r_G": "0x<48B hex>", "k_r_G": "0x<48B hex>"}, ...].
"""

from __future__ import annotations

import argparse
import json
import sys


def _hex_bytes(s: str, what: str = "value") -> bytes:
    """'0x'-prefixed hex -> bytes, with a real error instead of silently
    chopping two characters off an unprefixed string."""
    if not s.startswith("0x"):
        raise SystemExit(f"error: {what} must be 0x-prefixed hex, got {s[:10]!r}...")
    try:
        return bytes.fromhex(s[2:])
    except ValueError:
        raise SystemExit(f"error: {what} is not valid hex")


def _load_crs(path: str):
    from .crs import CurdleproofsCrs

    with open(path) as f:
        return CurdleproofsCrs.from_json(f.read())


def _load_trackers(path: str):
    from .whisk import WhiskTracker

    with open(path) as f:
        items = json.load(f)
    return [WhiskTracker(_hex_bytes(t["r_G"], "r_G"),
                         _hex_bytes(t["k_r_G"], "k_r_G")) for t in items]


def _dump_trackers(trackers, path: str) -> None:
    with open(path, "w") as f:
        json.dump([{"r_G": "0x" + t.r_G.hex(),
                    "k_r_G": "0x" + t.k_r_G.hex()} for t in trackers],
                  f, indent=1)


def _rng(seed: int | None):
    from .host.rng import StdRng

    if seed is not None:
        return StdRng.seed_from_u64(seed)
    import os

    return StdRng.seed_from_u64(int.from_bytes(os.urandom(8), "little"))


def cmd_crs(args) -> int:
    from .curdleproofs import generate_crs

    crs = generate_crs(args.ell)
    out = crs.to_json()
    if args.output == "-":
        print(out)
    else:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"wrote CRS (ell={args.ell}) to {args.output}", file=sys.stderr)
    return 0


def cmd_shuffle_prove(args) -> int:
    from .whisk import generate_whisk_shuffle_proof

    crs = _load_crs(args.crs)
    pre = _load_trackers(args.pre)
    post, proof = generate_whisk_shuffle_proof(_rng(args.seed), crs, pre)
    with open(args.proof, "wb") as f:
        f.write(proof)
    _dump_trackers(post, args.post)
    print(f"proof {len(proof)} B -> {args.proof}; "
          f"{len(post)} post trackers -> {args.post}", file=sys.stderr)
    return 0


def cmd_shuffle_verify(args) -> int:
    from .host.serde import SerializationError
    from .whisk import is_valid_whisk_shuffle_proof

    crs = _load_crs(args.crs)
    pre = _load_trackers(args.pre)
    post = _load_trackers(args.post)
    with open(args.proof, "rb") as f:
        proof = f.read()
    try:
        ok = is_valid_whisk_shuffle_proof(_rng(args.seed), crs, pre, post,
                                          proof)
    except SerializationError as e:  # malformed bytes are invalid proofs
        print(f"INVALID ({e})")
        return 1
    print("valid" if ok else "INVALID")
    return 0 if ok else 1


def cmd_shuffle_verify_batch(args) -> int:
    """Verify a chain-sync segment: manifest JSON is a list of
    {"pre": <tracker-json path>, "post": <path>, "proof": <proof path>},
    resolved relative to the manifest file."""
    import os

    from .host.serde import SerializationError
    from .whisk import is_valid_whisk_shuffle_proofs

    crs = _load_crs(args.crs)
    base = os.path.dirname(os.path.abspath(args.manifest))
    with open(args.manifest) as f:
        entries = json.load(f)

    def rel(p):
        return p if os.path.isabs(p) else os.path.join(base, p)

    shuffles = []
    for e in entries:
        with open(rel(e["proof"]), "rb") as f:
            proof = f.read()
        shuffles.append((_load_trackers(rel(e["pre"])),
                         _load_trackers(rel(e["post"])), proof))
    try:
        verdicts = is_valid_whisk_shuffle_proofs(_rng(args.seed), crs,
                                                 shuffles, identify=True)
    except SerializationError as e:
        print(f"INVALID ({e})")
        return 1
    if verdicts is True:
        print(f"valid ({len(shuffles)} shuffles)")
        return 0
    for i, ok in enumerate(verdicts):
        if not ok:
            print(f"INVALID: shuffle {i}")
    return 1


def cmd_tracker_prove(args) -> int:
    from .whisk import WhiskTracker, generate_whisk_tracker_proof

    tracker = WhiskTracker(_hex_bytes(args.r_g, "--r-g"),
                           _hex_bytes(args.k_r_g, "--k-r-g"))
    k = int(args.k, 0)
    proof = generate_whisk_tracker_proof(_rng(args.seed), tracker, k)
    with open(args.proof, "wb") as f:
        f.write(proof)
    print(f"tracker proof {len(proof)} B -> {args.proof}", file=sys.stderr)
    return 0


def cmd_tracker_verify(args) -> int:
    from .whisk import WhiskTracker, is_valid_whisk_tracker_proof

    from .host.serde import SerializationError

    tracker = WhiskTracker(_hex_bytes(args.r_g, "--r-g"),
                           _hex_bytes(args.k_r_g, "--k-r-g"))
    with open(args.proof, "rb") as f:
        proof = f.read()
    try:
        ok = is_valid_whisk_tracker_proof(
            tracker, _hex_bytes(args.k_commitment, "--k-commitment"), proof)
    except SerializationError as e:
        print(f"INVALID ({e})")
        return 1
    print("valid" if ok else "INVALID")
    return 0 if ok else 1


def cmd_info(args) -> int:
    """The backend's name (or why it cannot be built here), the torch
    version, the card (or that there is none), the kernel store and the
    kernels it holds for this tree, and whether the native runtime is
    present."""
    import os

    import torch

    from . import backend as be
    from .host import native
    from .ops import aot

    info = {"native_runtime": bool(native.available())}
    name = os.environ.get("CURDLEPROOFS_BACKEND", "torch").lower()
    try:
        info["backend"] = be.get_backend().name
    except (RuntimeError, ValueError) as e:  # a card backend with no card
        info["backend"] = f"{name} (unavailable: {e})"
    info["torch"] = torch.__version__
    info["device"] = (torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "none (no CUDA card)")
    info["kernel_store"] = str(aot.store_dir())
    info["kernels_built"] = aot.stored()
    print(json.dumps(info, indent=1))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m curdleproofs_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("crs", help="generate a seeded dev CRS (hex-JSON)")
    c.add_argument("--ell", type=int, required=True)
    c.add_argument("-o", "--output", default="-")
    c.set_defaults(fn=cmd_crs)

    c = sub.add_parser("shuffle-prove", help="whisk shuffle + proof")
    c.add_argument("--crs", required=True)
    c.add_argument("--pre", required=True, help="pre-tracker JSON")
    c.add_argument("--post", required=True, help="output post-tracker JSON")
    c.add_argument("--proof", required=True, help="output proof file")
    c.add_argument("--seed", type=int, default=None)
    c.set_defaults(fn=cmd_shuffle_prove)

    c = sub.add_parser("shuffle-verify", help="verify a whisk shuffle proof")
    c.add_argument("--crs", required=True)
    c.add_argument("--pre", required=True)
    c.add_argument("--post", required=True)
    c.add_argument("--proof", required=True)
    c.add_argument("--seed", type=int, default=None)
    c.set_defaults(fn=cmd_shuffle_verify)

    c = sub.add_parser("shuffle-verify-batch",
                       help="verify a manifest of shuffles with one "
                            "accumulated MSM")
    c.add_argument("--crs", required=True)
    c.add_argument("--manifest", required=True,
                   help='JSON: [{"pre": path, "post": path, "proof": path}]')
    c.add_argument("--seed", type=int, default=None)
    c.set_defaults(fn=cmd_shuffle_verify_batch)

    c = sub.add_parser("tracker-prove", help="tracker opening (DLEQ) proof")
    c.add_argument("--r-g", required=True, help="0x-hex 48B compressed r*G")
    c.add_argument("--k-r-g", required=True, help="0x-hex 48B k*r*G")
    c.add_argument("--k", required=True, help="secret scalar (int or 0x-hex)")
    c.add_argument("--proof", required=True, help="output proof file")
    c.add_argument("--seed", type=int, default=None)
    c.set_defaults(fn=cmd_tracker_prove)

    c = sub.add_parser("tracker-verify", help="verify a tracker opening")
    c.add_argument("--r-g", required=True)
    c.add_argument("--k-r-g", required=True)
    c.add_argument("--k-commitment", required=True, help="0x-hex 48B k*G")
    c.add_argument("--proof", required=True)
    c.set_defaults(fn=cmd_tracker_verify)

    c = sub.add_parser("info",
                       help="backend / card / kernels / runtime report")
    c.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
