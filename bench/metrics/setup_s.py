"""setup_s: seconds from the process's start to the window's start:
imports, the kernels' build (the first run of a checkout), weights, the
warm-up and the cell's set-up steps."""


def value(run):
    return run["setup_s"]
