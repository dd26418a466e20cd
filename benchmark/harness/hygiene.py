"""The checks that no run loaded JAX or the JAX package, and that the
timed process loaded none of the reference (it lives in its own process,
`refproc.py`; only a control puts it in the program's place)."""

from __future__ import annotations

import sys

# top-level module names (the part before the first dot), compared whole:
# the port's own name, curdleproofs_tpu_torch, begins with the JAX
# package's and is not one of them
FORBIDDEN = ("jax", "jaxlib", "flax", "curdleproofs_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names present in `modules` (default
    `sys.modules`), sorted."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def reference_modules(modules=None) -> list[str]:
    """The reference's top-level names present in `modules`."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & {"cpref"})
