"""The yardstick of the roofline readers: the kernels of each layer, by
name, and the bytes each layer's work needs, counted from the matrix alone.

The counts never read the port's tables, so any implementation of the same
apply or product is held to the same work: n rows, nnz entries of A,
nnz_L entries of L (A's strict lower triangle), B columns; 8-byte values,
4-byte indices; each input read once and each output written once.

    apply z = (L L^T)^-1 r    12 nnz_L + 8 n + 16 n B
        L's values and column indices, the diagonal, r in and z out
    SpMV y = A p              12 nnz + 16 n B
        A's values and column indices, p in and y out

A solve of k iterations needs k + 1 applies (one before the loop, one an
iteration) and k products; a slab dispatch of s steps needs s + 1 applies
and s products on the slots that hold a request.  Least time = bytes /
``peaks.HBM_BYTES_PER_S``.  Masked steps after convergence count in the
time, not in the need.
"""
from __future__ import annotations

from .peaks import HBM_BYTES_PER_S

#: B1 and B3 (``kernels/csrc/hbmc_trisolve.cu``)
APPLY_KERNELS = ("segment_single", "fused_segment_batched")
#: B2 and B4 (``kernels/csrc/sell_spmv.cu``)
SPMV_KERNELS = ("sell_spmv",)


def apply_bytes(n: int, nnz_lower: int, b: int) -> int:
    return 12 * nnz_lower + 8 * n + 16 * n * b


def spmv_bytes(n: int, nnz: int, b: int) -> int:
    return 12 * nnz + 16 * n * b


def is_kernel_of(name: str, kernels: tuple[str, ...]) -> bool:
    return any(k in name for k in kernels)


def share(trace, kernels: tuple[str, ...], need_bytes: int):
    """Percent of the byte bound: the least time of ``need_bytes`` over the
    traced device time of ``kernels``; None where they did not run."""
    if trace is None:
        return None
    seconds = trace.seconds_where(lambda name: is_kernel_of(name, kernels))
    if seconds <= 0:
        return None
    return 100.0 * need_bytes / HBM_BYTES_PER_S / seconds


def solve_applies(requests) -> int:
    return sum(r.iterations + 1 for r in requests)


def solve_products(requests) -> int:
    return sum(r.iterations for r in requests)


def occupied(dispatch: dict) -> int:
    return sum(r is not None for r in dispatch["rids"])
