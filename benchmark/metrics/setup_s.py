"""setup_s: process start to the first timed call (the import, the
kernel load, the inputs and the warm-up of the cell's own shapes)."""


def read(run):
    return run.setup_s
