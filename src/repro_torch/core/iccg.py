"""Preconditioned conjugate gradient (ICCG when preconditioner = IC(0)).

Port of the single-RHS half of ``repro.core.iccg``.  The reference runs the
loop as a device-side ``lax.while_loop``; here it is a host loop over
device tensors that reads one device flag per iteration (``.item()``, the
loop condition).  The state, the health monitor and the final status stay
on the device and follow the reference step for step.  The SpMV is the
SELL-w product through ``kernels.sell_spmv``; dots and axpys are PyTorch
ops, as they were XLA ops in the reference.

Convergence criterion: relative residual 2-norm < rtol (paper: 1e-7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..kernels.sell_spmv import sell_spmv

# ---------------------------------------------------------------------------
# Solve-status taxonomy (identical codes and names to the reference).
#
#   RUNNING    -- still iterating (never a final status of pcg)
#   CONVERGED  -- relative residual dropped below rtol
#   MAXITER    -- iteration budget exhausted with a finite, healthy state
#   BREAKDOWN  -- non-positive curvature (p^T A p <= 0) or a non-finite
#                 residual / pairing; the reported iterate is the last
#                 *finite* one
#   DIVERGED   -- relres grew past ``divergence_factor`` times its best
#   STAGNATED  -- no new best relres for ``stagnation_window`` iterations
#
# Detection is select-based (``torch.where``): on healthy inputs every guard
# selects the update the unguarded loop computed.
# ---------------------------------------------------------------------------

RUNNING, CONVERGED, MAXITER, BREAKDOWN, DIVERGED, STAGNATED = range(6)
STATUS_NAMES = ("RUNNING", "CONVERGED", "MAXITER", "BREAKDOWN", "DIVERGED",
                "STAGNATED")
UNHEALTHY_STATUSES = ("BREAKDOWN", "DIVERGED", "STAGNATED")

#: relres > factor * best-so-far trips DIVERGED
DIVERGENCE_FACTOR = 1e8
#: iterations without a new best relres before STAGNATED trips
STAGNATION_WINDOW = 1000


def status_name(code) -> str:
    """Human-readable name of a solve-status code."""
    return STATUS_NAMES[int(code)]


def spmv_sell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
              n: int) -> torch.Tensor:
    """SELL-w SpMV through the kernel wrapper.  vals/cols: (n_slices, K, w);
    the slice-row-major result is cut to the matrix dimension ``n``."""
    return sell_spmv(vals, cols, x)[:n]


@dataclasses.dataclass
class PCGResult:
    x: np.ndarray
    iterations: int
    relres: float
    converged: bool
    history: np.ndarray   # relative residual norm per iteration (padded NaN)
    status: str = "CONVERGED"


def _pcg_device(spmv: Callable[[torch.Tensor], torch.Tensor],
                precond: Callable[[torch.Tensor], torch.Tensor],
                b: torch.Tensor,
                rtol: float = 1e-7,
                maxiter: int = 10_000,
                record_history: bool = False,
                divergence_factor: float | None = DIVERGENCE_FACTOR,
                stagnation_window: int | None = STAGNATION_WINDOW):
    """Device core of ``pcg``: tensors in, tensors out.

    Returns ``(x, iterations, relres, status, history)`` as tensors on
    ``b``'s device.  The health monitor is the reference's: a non-SPD
    pairing (``p^T A p <= 0``, NaN included) or a non-finite
    residual/pairing stops with ``BREAKDOWN`` and the last finite iterate
    ``x_prev`` is reported; ``relres`` past ``divergence_factor * best``
    stops with ``DIVERGED``; ``stagnation_window`` iterations without a new
    best stop with ``STAGNATED``.
    """
    if divergence_factor is None:
        divergence_factor = float("inf")
    if stagnation_window is None:
        stagnation_window = maxiter + 1
    dev = b.device
    # status codes as device scalars, made once (not one copy per use)
    codes = torch.arange(len(STATUS_NAMES), dtype=torch.int32, device=dev)

    def code(c: int) -> torch.Tensor:
        return codes[c]

    bnorm = torch.linalg.vector_norm(b)
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)

    x = torch.zeros_like(b)
    x_prev = x
    r = b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    # ||r|| rides in the state: one full-vector reduction per step
    rnorm = torch.linalg.vector_norm(r)
    relres0 = rnorm / bnorm
    # a non-finite initial state (NaN/Inf in b, or a preconditioner that
    # produced one) is a breakdown before the first iteration
    init_ok = torch.isfinite(relres0) & torch.isfinite(rz)
    status = torch.where(init_ok, code(RUNNING), code(BREAKDOWN))
    it = torch.zeros((), dtype=torch.int64, device=dev)
    best = relres0
    since_best = code(0)
    if record_history:
        hist = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype,
                          device=dev)
        hist[0] = relres0
    else:
        hist = torch.zeros((0,), dtype=b.dtype, device=dev)

    while bool(((rnorm / bnorm >= rtol) & (it < maxiter)
                & (status == RUNNING)).item()):
        ap = spmv(p)
        pap = torch.dot(p, ap)
        alpha = rz / pap
        x2 = x + alpha * p
        r2 = r - alpha * ap
        z = precond(r2)
        rz2 = torch.dot(r2, z)
        beta = rz2 / rz
        p2 = z + beta * p
        rnorm2 = torch.linalg.vector_norm(r2)
        relres2 = rnorm2 / bnorm
        # pap > 0 is False for NaN pap too.  A broken step leaves the loop
        # (status leaves RUNNING) and its poisoned r, p are never read; the
        # rollback to x_prev happens once, after the loop.
        ok = (pap > 0) & torch.isfinite(rnorm2) & torch.isfinite(rz2)
        rz = torch.where(ok, rz2, rz)
        rnorm = torch.where(ok, rnorm2, rnorm)
        it = torch.where(ok, it + 1, it)
        improved = relres2 < best
        diverged = ok & (relres2 > divergence_factor * best)
        since_best = torch.where(
            ok, torch.where(improved, code(0), since_best + 1), since_best)
        stagnated = ok & (since_best >= stagnation_window)
        best = torch.where(ok, torch.minimum(best, relres2), best)
        status = torch.where(
            ~ok, code(BREAKDOWN),
            torch.where(diverged, code(DIVERGED),
                        torch.where(stagnated, code(STAGNATED), status)))
        if record_history:
            hist[it] = torch.where(ok, relres2, hist[it])
        x_prev, x, r, p = x, x2, r2, p2

    # a BREAKDOWN exit left the poisoned update in x; report the last
    # finite iterate instead
    x = torch.where(status == BREAKDOWN, x_prev, x)
    relres = rnorm / bnorm
    status = torch.where(status == RUNNING,
                         torch.where(relres < rtol, code(CONVERGED),
                                     code(MAXITER)),
                         status)
    return x, it, relres, status, hist


def pcg(spmv: Callable[[torch.Tensor], torch.Tensor],
        precond: Callable[[torch.Tensor], torch.Tensor],
        b: torch.Tensor,
        rtol: float = 1e-7,
        maxiter: int = 10_000,
        record_history: bool = False,
        divergence_factor: float | None = DIVERGENCE_FACTOR,
        stagnation_window: int | None = STAGNATION_WINDOW) -> PCGResult:
    """Standard PCG on ``b``'s device; ends with a definite ``status``.

    A zero RHS converges at 0 iterations with ``x = 0``; NaN/Inf inputs,
    non-SPD pairings, divergence and stagnation stop early (the reported
    ``x`` is the last finite iterate).
    """
    x, it, relres, status, hist = _pcg_device(
        spmv, precond, b, rtol=rtol, maxiter=maxiter,
        record_history=record_history, divergence_factor=divergence_factor,
        stagnation_window=stagnation_window)
    relres = float(relres)
    return PCGResult(x=x.cpu().numpy(), iterations=int(it), relres=relres,
                     converged=relres < rtol, history=hist.cpu().numpy(),
                     status=status_name(status))
