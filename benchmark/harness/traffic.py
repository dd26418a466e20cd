"""The one traffic generator: a mix's data file in, the order of work out.

A mix (`benchmark/traffic/<mix>.json`) names the entry that drives the
program (`"entry"`, a module of `benchmark/entries/`), the entry's
parameters (`"params"`) and the kinds of work in each period of the
closed loop (`"period"`: kind -> count).  Every period holds the same
kinds in the same numbers, in an order drawn from the seed, so every seed
gets the same work in another order.
"""

from __future__ import annotations

import json
import pathlib
import random
from typing import Iterator


def load_mix(root: pathlib.Path, name: str) -> dict:
    mix = json.loads((root / "benchmark" / "traffic" / f"{name}.json")
                     .read_text())
    for key in ("entry", "period", "params"):
        if key not in mix:
            raise ValueError(f"traffic {name}: no {key!r}")
    if not mix["period"] or min(mix["period"].values()) < 1:
        raise ValueError(f"traffic {name}: a period needs kinds, each at "
                         f"least once")
    return mix


def sequence(mix: dict, seed: int) -> Iterator[str]:
    """The kinds of work in the order the closed loop sends them: period
    after period, each a seeded shuffle of the period's multiset."""
    rnd = random.Random(f"traffic:{seed}")
    period = [kind for kind, count in sorted(mix["period"].items())
              for _ in range(count)]
    while True:
        order = period[:]
        rnd.shuffle(order)
        yield from order
