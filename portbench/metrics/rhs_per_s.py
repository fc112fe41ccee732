"""rhs_per_s: requests completed in the window over its length (host
clock)."""


def read(run):
    return len(run.requests) / run.window_s
