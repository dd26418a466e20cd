"""fold_roofline_pct.verify: the bucket fold's share of its roofline in
the sync cell (see `harness/fold_roofline.py`)."""

from harness.fold_roofline import roofline_pct


def read(run):
    return roofline_pct(run)
