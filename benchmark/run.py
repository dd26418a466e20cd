"""Run one cell of the benchmark once (see `harness/core.py`):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the `perf_counter` clock, from its age in
    /proc (so set-up counts the interpreter's start too)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    T_START = _process_start()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from harness.core import main

    sys.exit(main(t_start=T_START))
