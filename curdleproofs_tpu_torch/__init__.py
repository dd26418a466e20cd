"""curdleproofs_tpu_torch: the Curdleproofs shuffle argument on PyTorch + CUDA.

The PyTorch/CUDA port of `curdleproofs_tpu`, module for module: the same
protocol over BLS12-381 (the proof system behind Ethereum's Whisk SSLE),
bit-exact against the Rust reference (`asn-d6/curdleproofs`) test vectors,
with every device MSM on hand-written Hopper kernels.  It imports neither
jax nor the JAX package.

Layout:
- `host/`  — scalar host runtime: field/curve ints, Merlin transcript, StdRng
             clone, native C++ runtime (built at first use)
- `ops/`   — device math: limb field ops, G1 ops, Pippenger MSM (torch), the
             CUDA kernels' wrappers (`ops/kernels.py`, sources in `csrc/`)
- protocol modules — transcript, commitments, sub-arguments, shuffle argument,
  whisk
- `convert.py` — state carried across from the JAX package (bases, CRS)
"""

from .constants import N_BLINDERS  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (importing torch/the native lib only when used)."""
    if name in ("CurdleproofsProof", "generate_crs"):
        from . import curdleproofs as _m

        return getattr(_m, name)
    if name == "CurdleproofsCrs":
        from .crs import CurdleproofsCrs

        return CurdleproofsCrs
    if name in ("WhiskTracker", "generate_whisk_shuffle_proof",
                "is_valid_whisk_shuffle_proof", "is_valid_whisk_shuffle_proofs",
                "generate_whisk_tracker_proof",
                "is_valid_whisk_tracker_proof",
                "is_valid_whisk_tracker_proofs"):
        from . import whisk as _m

        return getattr(_m, name)
    if name == "StdRng":
        from .host.rng import StdRng

        return StdRng
    raise AttributeError(name)
