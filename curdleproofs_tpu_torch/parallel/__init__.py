"""Multi-device scaling: the sharded MSM over a grid of devices, batch
verification (one deduped MSM, streamed or sharded) and the batched prover
(the JAX package's `parallel/`).

Exports resolve lazily: importing the package pulls in no torch module.
`sharded_msm` names the submodule (the import system binds that name once
the submodule loads, so it is the submodule before then too); its function
is `sharded_msm.sharded_msm`.
"""

import importlib

__all__ = ["sharded_msm_kernel", "make_msm_mesh"]


def __getattr__(name):
    if name in ("sharded_msm_kernel", "make_msm_mesh", "sharded_msm"):
        m = importlib.import_module(f"{__name__}.sharded_msm")
        return m if name == "sharded_msm" else getattr(m, name)
    raise AttributeError(name)
