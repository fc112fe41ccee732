"""spmv_roofline.service (layer: SpMV): the least time of the batched
products the window's slab dispatches needed, over the profiled device time
of the SELL-w SpMV kernels.  Byte count and kernel names:
``lib/roofline.py``."""
from portbench.lib import roofline


def read(run):
    if not run.dispatches:
        return None
    n, nnz = run.facts["n"], run.facts["nnz"]
    need = sum(d["steps"] * roofline.spmv_bytes(n, nnz, roofline.occupied(d))
               for d in run.dispatches)
    return roofline.share(run.device_trace, roofline.SPMV_KERNELS, need)
