"""latency_p95_ms: the 95th percentile, over every request completed in
the window, of the time from the start of its ``submit`` call to the end of
the ``step`` that returned it (host clock)."""
import numpy as np


def read(run):
    if not run.requests:
        return None
    lat = [r.t_done - r.t_submit for r in run.requests]
    return 1e3 * float(np.percentile(lat, 95))
