"""The frozen yardstick: the card's integer bound and the fold's least work.

Copies of the program's own arithmetic (`tools/common.int_rate`,
`tools/kernel_probe.fold_row_kinds`), frozen here so that a later change
to the program moves neither.  A fold's least work is counted from the
data of each launch: the products that the fold's words need, whatever
implements the fold.
"""

from __future__ import annotations

import subprocess

IMAD_PER_CLK_PER_SM = 64      # 32-bit integer multiply-add, compute capability 9.0
MULS_PER_PRODUCT = 600        # a 381-bit product: 300 32x32->64 products, 2 multiplies each
Q = 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab
ONE_MONT = (1 << 384) % Q     # the resident bases' Montgomery one
# the field products that write a fold row's words (g1_fold.cuh): a live
# row is a mixed add; the full-add fold also pays for its dead rows
PRODUCTS = {"live": 11, "dead_pm1": 3, "dead_y": 5, "dead_x": 12}


def int_rate(device=None) -> float:
    """The card's 32-bit integer multiplies a second: SMs x
    IMAD_PER_CLK_PER_SM x the SM's maximum clock (`nvidia-smi`)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    clock_hz = float(out.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * IMAD_PER_CLK_PER_SM * clock_hz


_COLS: dict = {}


def _packed_col(v: int, dev):
    """A Montgomery int as a [12, 1] column of packed 32-bit words, as the
    resident bases hold them (made once a device: no copy to the device
    after the first)."""
    import numpy as np
    import torch

    if (v, dev) not in _COLS:
        w = np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)],
                     dtype=np.uint32)
        _COLS[v, dev] = torch.from_numpy(w.view(np.int32)).to(dev)[:, None]
    return _COLS[v, dev]


def fold_products(ext_px, ext_py, ext_zb, plan, madd: bool):
    """The least field products that write the words of one fold launch,
    as a 0-dim device tensor (read it after the window: no sync here).
    The mixed-add fold computes its live rows alone; the full-add fold
    writes every row, dead ones at their own price."""
    e = plan.long()
    live = ext_zb[e] != 0
    if madd:
        return live.sum() * PRODUCTS["live"]
    x0 = (ext_px == 0).all(0)[e]
    pm1 = ((ext_py == _packed_col(ONE_MONT, plan.device)).all(0)
           | (ext_py == _packed_col(Q - ONE_MONT, plan.device)).all(0))[e]
    return (live.sum() * PRODUCTS["live"]
            + (~live & x0 & pm1).sum() * PRODUCTS["dead_pm1"]
            + (~live & x0 & ~pm1).sum() * PRODUCTS["dead_y"]
            + (~live & ~x0).sum() * PRODUCTS["dead_x"])


def least_seconds(products: int, rate: float) -> float:
    """The least time `products` field products take at `rate` 32-bit
    multiplies a second: the bound by operations."""
    return products * MULS_PER_PRODUCT / rate
