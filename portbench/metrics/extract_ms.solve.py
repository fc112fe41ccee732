"""extract_ms.solve (layer: host path): mean host milliseconds of the
program's ``solve.extract`` span over the window's solves: the answer and
the loop's scalars copied to the host, the answer gathered out of the
round-major layout and the HBMC order (``lib/spans.py``)."""
from portbench.lib import spans


def read(run):
    got = spans.in_window(run, ("solve.extract",))
    if not got:
        return None
    return 1e3 * spans.seconds(got) / len(got)
