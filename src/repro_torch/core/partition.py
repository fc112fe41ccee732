"""Distribution of the HBMC ICCG solver over a device mesh: one-shot wrappers.

Port of the solve wrappers of ``repro.core.partition``.  The distribution
layer proper lives in the plan stack:

    core/plan.py        ``build_plan(a, ..., mesh=, mesh_axis=)``: a
                        mesh-aware ``SolverPlan`` (factor once, solve many,
                        refactor in place), whose preconditioner apply is
                        the fused round-major sweep with one all-gather per
                        step
    core/trisolve.py    ``DistributedRoundMajorPreconditioner`` /
                        ``_dist_substitute_fused``: the sharded fused
                        fwd+bwd substitution (the shard step kernel on each
                        rank's lane block)
    core/iccg.py        ``make_sharded_spmv``: row/slice-sharded ELL/SELL
                        SpMV with one all-gather per product

Parallel-ordering semantics map onto the mesh as the paper maps them onto
threads (§4.4.3), one level up: colors are sequential rounds, the level-1
blocks of a color are spread over the ranks (the fused tables' lane axis is
sharded), and the w lanes of a block are the threads of a device.

Every rank calls these with the same arguments (SPMD).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .plan import BatchedICCGReport, ICCGReport, build_plan


def distributed_iccg(a: sp.spmatrix, b: np.ndarray, mesh, *,
                     axis: str = "data", method: str = "hbmc",
                     block_size: int = 32, w: int = 8, shift: float = 0.0,
                     rtol: float = 1e-7, maxiter: int = 10_000,
                     spmv_format: str = "sell",
                     dtype: torch.dtype = torch.float64,
                     record_history: bool = False) -> ICCGReport:
    """One-shot distributed solve: mesh-aware plan, solve, report.

    Takes the original system (``a``, ``b``): ordering, padding and the
    round-major embedding happen inside the plan, and ``report.x`` carries
    the solution in the caller's ordering.  Workloads solving against one
    matrix repeatedly should hold the plan: ``build_plan(a, ...,
    mesh=mesh)`` then ``plan.solve(...)`` / ``plan.refactor(...)``.
    """
    plan = build_plan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      mesh=mesh, mesh_axis=axis)
    rep = plan.solve(np.asarray(b), rtol=rtol, maxiter=maxiter,
                     record_history=record_history)
    rep.setup_seconds += plan.timings.total
    return rep


def distributed_iccg_batched(a: sp.spmatrix, b: np.ndarray, mesh, *,
                             axis: str = "data", method: str = "hbmc",
                             block_size: int = 32, w: int = 8,
                             shift: float = 0.0, rtol: float = 1e-7,
                             maxiter: int = 10_000,
                             spmv_format: str = "sell",
                             dtype: torch.dtype = torch.float64,
                             record_history: bool = False
                             ) -> BatchedICCGReport:
    """Multi-RHS variant of ``distributed_iccg`` (``b``: (n, B))."""
    plan = build_plan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      mesh=mesh, mesh_axis=axis)
    rep = plan.solve_batched(np.asarray(b), rtol=rtol, maxiter=maxiter,
                             record_history=record_history)
    rep.setup_seconds += plan.timings.total
    return rep
