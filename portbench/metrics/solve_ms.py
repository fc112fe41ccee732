"""solve_ms: the window's length over the solves completed in it (host
clock): the caller's time to solution, host embed and extract included."""


def read(run):
    return 1e3 * run.window_s / len(run.requests) if run.requests else None
