"""The benchmark's harness: one general runner for every cell.

`core.main` runs one cell once; `manifest` reads `BENCHMARK.json`;
`traffic` is the one generator that every mix's data file feeds;
`trace` reduces a `torch.profiler` trace to device busy time, idle gaps
and kernel times; `yardstick` holds the frozen bounds (the integer rate,
the fold's least work); `hygiene` is the check that no JAX module loaded.
Entries (`benchmark/entries/`), configurations (`benchmark/configs/`),
mixes (`benchmark/traffic/`) and metric readers (`benchmark/metrics/`) are
files of their own, found by the names in `BENCHMARK.json`.

An entry drives one entry point of the program and defines: `CALL_SPAN`
(the name of a call's span); `setup(ctx)` (the inputs from the seed, and
the reference's copies) and `instrument(state)` (spans and counters around
the program's layers); `units(state, kind)` (proofs in a call of that kind);
`run(state, kind)` (the timed call), `run_control(state, kind)` (the
reference with a guarantee broken, in the program's place) and `FAULTS`
(wrappers that break the timed path, for the tests); `report(state)`
(lines for stderr), `release(state)` (drops the program's state) and
`judge(state, done)` (each number compared, with its limit).  A metric's
reader defines `read(run)`, which returns a number or None.
"""
