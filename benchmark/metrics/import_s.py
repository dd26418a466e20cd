"""import_s: the harness's clock around the program's import (torch's,
which the program needs, `curdleproofs_tpu_torch`'s and the entry's
modules) and the first load of every kernel library."""


def read(run):
    return run.setup["import_s"]
