"""embed_ms.solve (layer: host path): mean host milliseconds of the
program's ``solve.embed`` span over the window's solves: the RHS checked,
scattered into the HBMC order and the round-major layout, and uploaded
(``lib/spans.py``)."""
from portbench.lib import spans


def read(run):
    got = spans.in_window(run, ("solve.embed",))
    if not got:
        return None
    return 1e3 * spans.seconds(got) / len(got)
