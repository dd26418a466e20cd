"""fold_roofline_pct.prove: the bucket fold's share of its roofline in
the batched prover's cells (see `harness/fold_roofline.py`)."""

from harness.fold_roofline import roofline_pct


def read(run):
    return roofline_pct(run)
