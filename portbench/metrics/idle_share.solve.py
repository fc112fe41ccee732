"""idle_share.solve (layer: device): share of the traced window in which no
operation ran on the device (``lib/trace.py`` ``idle_share``)."""
from portbench.lib.trace import idle_share


def read(run):
    return idle_share(run.device_trace)
