"""One-shot ICCG front ends (port of ``repro.core.solvers``).

``solve_iccg`` builds a ``SolverPlan`` and solves once;
``solve_iccg_batched`` does the same for the columns of an (n, B) block.
Workloads that solve against one matrix repeatedly should hold the plan
instead:

    plan = build_plan(a, method="hbmc", block_size=16, w=8)
    rep = plan.solve(b)            # no host-side setup after the first
    plan.refactor(a_new)           # new values, same pattern: numeric only

The report carries the solution in the caller's ordering in both
``report.x`` and ``report.result.x``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..kernels.config import DEFAULT_DEVICE
from .plan import (_NP_DTYPES, BatchedICCGReport, ICCGReport,
                   build_plan)


def solve_iccg(a: sp.spmatrix, b: np.ndarray, method: str = "hbmc",
               block_size: int = 32, w: int = 8, shift: float = 0.0,
               rtol: float = 1e-7, maxiter: int = 10_000,
               spmv_format: str = "sell",
               dtype: torch.dtype = torch.float64,
               record_history: bool = False, layout: str = "round_major",
               scheduler: str = "coloring",
               device: str | torch.device = DEFAULT_DEVICE) -> ICCGReport:
    """Build a ``SolverPlan``, solve once, fold setup into the report's
    ``setup_seconds``."""
    plan = build_plan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      layout=layout, scheduler=scheduler, device=device)
    rep = plan.solve(b, rtol=rtol, maxiter=maxiter,
                     record_history=record_history)
    rep.setup_seconds += plan.timings.total
    return rep


def solve_iccg_batched(a: sp.spmatrix, b: np.ndarray, method: str = "hbmc",
                       block_size: int = 32, w: int = 8, shift: float = 0.0,
                       rtol: float = 1e-7, maxiter: int = 10_000,
                       spmv_format: str = "sell",
                       dtype: torch.dtype = torch.float64,
                       record_history: bool = False,
                       layout: str = "round_major",
                       scheduler: str = "coloring",
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> BatchedICCGReport:
    """Solve A x_j = b_j for all columns of ``b`` ((n, B)) in one PCG loop.

    The caller names ``dtype``, so ``b`` is cast to it here (the documented
    opt-in); ``plan.solve_batched`` itself rejects a float-dtype mismatch.
    """
    if dtype not in _NP_DTYPES:
        raise TypeError(f"dtype must be torch.float64 or torch.float32, "
                        f"got {dtype}")
    b = np.asarray(b, dtype=_NP_DTYPES[dtype])
    if b.ndim != 2:
        raise ValueError(f"solve_iccg_batched expects b of shape (n, B), "
                         f"got {b.shape}")
    plan = build_plan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      layout=layout, scheduler=scheduler, device=device)
    rep = plan.solve_batched(b, rtol=rtol, maxiter=maxiter,
                             record_history=record_history)
    rep.setup_seconds += plan.timings.total
    return rep
