"""device_idle_pct.prove: the share of the traced window in which no
kernel, copy or fill runs on the card (the union of device intervals), %."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None else None
