"""spmv_roofline.solve (layer: SpMV): the least time of the products
y = A p the window's solves needed (B = 1), over the profiled device time
of the SELL-w SpMV kernels.  Byte count and kernel names:
``lib/roofline.py``."""
from portbench.lib import roofline


def read(run):
    if not run.requests:
        return None
    need = roofline.solve_products(run.requests) * roofline.spmv_bytes(
        run.facts["n"], run.facts["nnz"], 1)
    return roofline.share(run.device_trace, roofline.SPMV_KERNELS, need)
