"""segments_s (layer: segment analysis): host seconds of the program's
``segments`` spans in set-up: the barrier-free segments of each step
table, computed at its first apply (``lib/spans.py``)."""
from portbench.lib import spans


def read(run):
    got = spans.in_setup(run, ("segments",))
    return spans.seconds(got) if got else None
