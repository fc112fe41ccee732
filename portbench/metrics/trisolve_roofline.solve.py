"""trisolve_roofline.solve (layer: round-major apply): the least time of the
IC(0) applies the window's solves needed (B = 1), over the profiled device
time of the apply's kernels.  Byte count and kernel names:
``lib/roofline.py``."""
from portbench.lib import roofline


def read(run):
    if not run.requests:
        return None
    need = roofline.solve_applies(run.requests) * roofline.apply_bytes(
        run.facts["n"], run.facts["nnz_lower"], 1)
    return roofline.share(run.device_trace, roofline.APPLY_KERNELS, need)
