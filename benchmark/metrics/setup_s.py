"""setup_s: process start to the first measured step (imports, kernel
libraries, inputs and weights, the program's set-up, the checked steps and
the warm-up)."""


def read(run):
    return run.setup_s
