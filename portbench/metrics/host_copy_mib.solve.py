"""host_copy_mib.solve (layer: host path): MiB a solve moves between host
and device, the ``nbytes`` of the program's ``solve.embed`` (the upload)
and ``solve.extract`` (the answer and the loop's scalars copied down)
spans, per solve in the window (``lib/spans.py``).  The program counts the
bytes where they cross, so a plan on the CPU reads 0."""
from portbench.lib import spans


def read(run):
    got = spans.in_window(run, ("solve.embed", "solve.extract"))
    solves = sum(r.name == "solve.embed" for r in got or ())
    if not solves:
        return None
    return sum(r.nbytes for r in got) / solves / 2**20
