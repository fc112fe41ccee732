"""vector_ms_per_iter.solve (layer: vector work): device milliseconds of
every kernel that is neither the apply nor the SpMV (``lib/roofline.py``'s
names), memory copies and sets left out, over the PCG iterations of the
traced window's solves."""
from portbench.lib import roofline

_OTHERS = roofline.APPLY_KERNELS + roofline.SPMV_KERNELS


def _vector(name: str) -> bool:
    return not (name.startswith(("Memcpy", "Memset"))
                or roofline.is_kernel_of(name, _OTHERS))


def read(run):
    t = run.device_trace
    iterations = roofline.solve_products(run.requests)
    if t is None or iterations == 0:
        return None
    seconds = t.seconds_where(_vector)
    return 1e3 * seconds / iterations if seconds > 0 else None
