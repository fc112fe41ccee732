"""trisolve_roofline.service (layer: round-major apply): the least time of
the batched IC(0) applies the window's slab dispatches needed, over the
profiled device time of the apply's kernels.  Byte count and kernel names:
``lib/roofline.py``."""
from portbench.lib import roofline


def read(run):
    if not run.dispatches:
        return None
    n, nnz_lower = run.facts["n"], run.facts["nnz_lower"]
    need = sum((d["steps"] + 1) * roofline.apply_bytes(
        n, nnz_lower, roofline.occupied(d)) for d in run.dispatches)
    return roofline.share(run.device_trace, roofline.APPLY_KERNELS, need)
