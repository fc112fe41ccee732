"""loop_idle_ms.solve (layer: PCG loop): device-idle milliseconds inside
the program's ``solve.loop`` spans, mapped onto the traced window, per
solve: what the loop's block boundaries cost the device, the flag read
after each block and the next replay's launch (``lib/spans.py``)."""
from portbench.lib import spans


def read(run):
    t = run.device_trace
    if t is None or not t.device:
        return None
    got = spans.in_window(run, ("solve.loop",))
    if not got:
        return None
    return 1e-3 * sum(spans.idle_us(run, got)) / len(got)
