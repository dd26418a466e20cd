"""prove_proofs_per_s: proofs returned in the window, over the window's
seconds (every wave of the closed loop counts)."""


def read(run):
    return run.units / run.window_s if run.units else None
