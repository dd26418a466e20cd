"""The reference's own process.

It makes a run's inputs from the seed and, once the window has closed,
judges the program's outputs, so that the timed process holds none of
the reference's objects and loads none of its code.  It starts with the
run and makes the inputs, with a pool of workers, while the timed
process imports the program; it waits, idle, while the window runs.

The parent (`core.main`) talks to it over its standard input and output,
one pickled message each way per step: the request (the entry, the
configuration, the mix's parameters, the seed, the cores), the inputs
back; the program's outputs, the checks back.  An entry's
`make_inputs(rctx)` returns (inputs, its own state), and its
`judge(rctx, state, outputs)` the checks.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import signal
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

HERE = pathlib.Path(__file__).resolve()


class RefContext:
    """What an entry's reference side gets: the configuration as run,
    the mix's parameters, the seed, and a pool of worker processes."""

    def __init__(self, cfg: dict, params: dict, seed: int, kinds: tuple,
                 workers: int):
        self.cfg, self.params, self.seed, self.kinds = cfg, params, seed, kinds
        self.workers = max(1, workers)
        self._pool = None

    def map(self, fn, items) -> list:
        """`fn` over `items` in the worker processes (forked: `fn` is a
        module-level function of the entry)."""
        items = list(items)
        if self.workers == 1 or len(items) < 2:
            return [fn(x) for x in items]
        if self._pool is None:
            self._pool = ProcessPoolExecutor(self.workers,
                                             mp_context=get_context("fork"))
        return list(self._pool.map(fn, items))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class RefProcess:
    """The parent's handle on the reference's process."""

    def __init__(self, root: pathlib.Path, entry: str, cfg: dict, params: dict,
                 seed: int, kinds: tuple, cores: list[int]):
        # a process group of its own: closing it ends its workers too
        self.proc = subprocess.Popen(
            [sys.executable, str(HERE)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, cwd=str(root), start_new_session=True)
        self._send({"root": str(root), "entry": entry, "cfg": cfg,
                    "params": params, "seed": seed, "kinds": kinds,
                    "cores": cores})

    def _send(self, msg) -> None:
        pickle.dump(msg, self.proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def _recv(self):
        try:
            ok, msg = pickle.load(self.proc.stdout)
        except EOFError:
            raise RuntimeError("the reference's process ended early "
                               f"(exit code {self.proc.wait()})") from None
        if not ok:
            raise RuntimeError("the reference's process failed:\n" + msg)
        return msg

    def inputs(self):
        return self._recv()

    def judge(self, outputs) -> dict:
        self._send(outputs)
        out = self._recv()
        self.close()
        return out

    def close(self) -> None:
        """End the process and its workers, wherever they are, and wait
        until none is left."""
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.proc.wait()
        for _ in range(200):
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                break
            time.sleep(0.05)


def _main() -> int:
    import importlib.util
    import traceback

    inp, out = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr          # the channel is for pickles alone

    def reply(ok, msg):
        pickle.dump((ok, msg), out, protocol=pickle.HIGHEST_PROTOCOL)
        out.flush()

    req = pickle.load(inp)
    root = pathlib.Path(req["root"])
    sys.path[:0] = [str(root / "benchmark"), str(root)]
    if req["cores"]:
        os.sched_setaffinity(0, req["cores"])
    rctx = RefContext(req["cfg"], req["params"], req["seed"],
                      tuple(req["kinds"]), len(req["cores"]) or 1)
    try:
        path = root / "benchmark" / "entries" / f"{req['entry']}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_ref_{req['entry']}", path)
        entry = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = entry   # the workers find its functions
        spec.loader.exec_module(entry)
        data, state = entry.make_inputs(rctx)
        rctx.close()
        reply(True, data)
        outputs = pickle.load(inp)
        if outputs is None:
            return 0
        checks = entry.judge(rctx, state, outputs)
        rctx.close()
        reply(True, checks)
    except Exception:
        rctx.close()
        reply(False, traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_main())
