"""Set-up: from the process's start to the end of the warm-up prove (imports,
inputs, kernel build or load, table build, the first prove)."""


def read(run):
    return run.setup_s
