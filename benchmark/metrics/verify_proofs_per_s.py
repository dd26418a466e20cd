"""verify_proofs_per_s: blocks whose batch completed in the window, over
the window's seconds (every call of the closed loop counts)."""


def read(run):
    return run.units / run.window_s if run.units else None
