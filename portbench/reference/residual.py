"""What an answer of the solver has to satisfy, checked in plain NumPy and
SciPy on the benchmark's own matrix and right-hand side.

The configuration states the guarantee: every answer converges, and its
true relative residual ||b - A x||_2 / ||b||_2, computed in float64 from
the matrix in the caller's ordering, lies below the configuration's
``rtol``.  That covers every layer an answer passes through: the
embedding into the plan's ordering and its extraction back, the PCG loop,
the SpMV, the preconditioner (an apply that is not SPD stops the loop), and
a service's packing into slab slots and retiring from them.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def true_relres(a: sp.csr_matrix, b: np.ndarray, x: np.ndarray) -> float:
    """||b - A x|| / ||b|| in float64; 1.0 for a zero b with x = 0."""
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    if x.shape != b.shape or not np.all(np.isfinite(x)):
        return float("inf")
    bnorm = np.linalg.norm(b)
    r = b - a @ x
    return float(np.linalg.norm(r) / (bnorm if bnorm > 0 else 1.0))
