"""The reference's inputs in the program's types: the same points, made
into the program's host objects, as a caller hands them over."""

from __future__ import annotations


def program_point(xy):
    """A program point from affine (x, y), None at infinity."""
    from curdleproofs_tpu_torch.host.g1 import G1

    return G1.infinity() if xy is None else G1(xy[0], xy[1], 1)


def program_crs(crs: dict):
    """The CRS, given as affine coordinates, in the program's type."""
    from curdleproofs_tpu_torch.crs import CurdleproofsCrs

    conv = program_point
    return CurdleproofsCrs(
        [conv(p) for p in crs["vec_G"]], [conv(p) for p in crs["vec_H"]],
        *(conv(crs[k]) for k in ("H", "G_t", "G_u", "G_sum", "H_sum")))


def reference_crs_affine(crs) -> dict:
    """The reference's CRS as affine coordinates (the reference's side)."""
    from cpref.host.g1 import G1

    out = {k: G1.batch_to_affine(getattr(crs, k)) for k in ("vec_G", "vec_H")}
    for k in ("H", "G_t", "G_u", "G_sum", "H_sum"):
        out[k] = getattr(crs, k).to_affine()
    return out
