"""setup_s: process start to the start of the window (host clock): making
the matrix and the right-hand sides, loading the kernel library, the plan
build (a service's first one), the first solves with their segment
analysis and graph captures, and the warm-up."""


def read(run):
    return run.setup_s
