"""One-shot ICCG front end (port of ``repro.core.solvers.solve_iccg``).

``solve_iccg`` builds a ``SolverPlan`` and solves once.  Workloads that
solve against one matrix repeatedly should hold the plan instead:

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
from .plan import ICCGReport, build_plan


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
