"""Preconditioned conjugate gradient (ICCG when preconditioner = IC(0)).

Port of ``repro.core.iccg``: the single-RHS loop (``pcg``), the batched
multi-RHS loop (``pcg_batched``) and the quantum-stepped slab loop of the
serving layer (``SlabState``, ``_pcg_slab_device``).  The reference runs
each loop as a device-side ``lax.while_loop``; here it is a host loop over
device tensors that reads one device flag per iteration (``.item()``, the
loop condition).  The state, the health monitor and the final status stay
on the device and follow the reference step for step.  The SpMV is the
SELL-w product through ``kernels.sell_spmv`` / ``sell_spmv_batched``; dots
and axpys are PyTorch ops, as they were XLA ops in the reference.

The batched loops compute per-column dots and norms as plain reductions
over dim 0 (``(p * ap).sum(0)``, ``vector_norm(r, dim=0)``), never as a
matrix product, and every guard as a ``torch.where`` select: a column's
float sequence then depends on its own data, the slab width and its slot,
never on what the other columns hold.

Convergence criterion: relative residual 2-norm < rtol (paper: 1e-7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.sell_spmv import sell_spmv, sell_spmv_batched

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


def spmv_sell_batched(vals: torch.Tensor, cols: torch.Tensor,
                      x: torch.Tensor, n: int) -> torch.Tensor:
    """SELL-w SpMV over B column vectors.  x: (n_pad, B) -> (n, B)."""
    return sell_spmv_batched(vals, cols, x)[:n]


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


# ---------------------------------------------------------------------------
# Batched multi-RHS PCG (one loop for B right-hand sides).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedPCGResult:
    x: np.ndarray           # (n, B) solutions
    iterations: np.ndarray  # (B,) per-RHS iteration counts
    relres: np.ndarray      # (B,) final relative residual norms
    converged: np.ndarray   # (B,) bool
    n_steps: int            # loop trips = max(iterations)
    # (maxiter+1, B) per-column relative residual norms (NaN once a column
    # has stopped, matching the single-RHS ``pcg`` histories column for
    # column); empty when record_history=False
    history: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0)))
    # (B,) per-column termination codes (indices into STATUS_NAMES)
    status: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), dtype=np.int32))

    @property
    def status_names(self) -> list[str]:
        """Per-column status names (``STATUS_NAMES[code]`` per column)."""
        return [STATUS_NAMES[int(s)] for s in self.status]


def _monitor_defaults(maxiter, divergence_factor, stagnation_window):
    if divergence_factor is None:
        divergence_factor = float("inf")
    if stagnation_window is None:
        stagnation_window = maxiter + 1
    return divergence_factor, stagnation_window


def _batched_step(spmv, precond, x, r, p, rz, active, best, since, bnorm,
                  codes, status, divergence_factor, stagnation_window):
    """One guarded PCG step on every column of a slab.

    Shared by the batched and the slab loop, so both perform the identical
    arithmetic.  A column whose pairing goes non-positive is frozen before
    the division (``alpha = 0``, as a converged column is), a column whose
    update produced a non-finite residual keeps its last finite state, and
    divergence/stagnation trip per column.  Returns the new carry plus
    ``ok`` (the columns that took the step) and ``relres2``.
    """
    ap = spmv(p)
    pap = (p * ap).sum(0)
    upd = active & (pap > 0)
    alpha = torch.where(upd, rz / pap, 0.0)
    x2 = x + alpha[None, :] * p
    r2 = r - alpha[None, :] * ap
    z = precond(r2)
    rz2 = (r2 * z).sum(0)
    beta = torch.where(upd, rz2 / rz, 0.0)
    p2 = torch.where(upd[None, :], z + beta[None, :] * p, p)
    relres2 = torch.linalg.vector_norm(r2, dim=0) / bnorm
    ok = upd & torch.isfinite(relres2) & torch.isfinite(rz2)
    broke = active & ~ok
    okc = ok[None, :]
    x = torch.where(okc, x2, x)
    r = torch.where(okc, r2, r)
    p = torch.where(okc, p2, p)
    rz = torch.where(ok, rz2, rz)
    improved = relres2 < best
    diverged = ok & (relres2 > divergence_factor * best)
    since = torch.where(ok, torch.where(improved, 0, since + 1), since)
    stagnated = ok & (since >= stagnation_window) & ~diverged
    best = torch.where(ok, torch.minimum(best, relres2), best)
    status = torch.where(
        broke, codes[BREAKDOWN],
        torch.where(diverged, codes[DIVERGED],
                    torch.where(stagnated, codes[STAGNATED], status)))
    return (x, r, p, rz, best, since, status, ok, relres2,
            ~diverged & ~stagnated)


def _init_columns(precond, r, rtol, codes):
    """Per-column start of a solve from residual ``r`` = b (x = 0).

    Returns ``(z, rz, bnorm, relres, active, status)``; a zero column gets
    ``bnorm = 1`` and is CONVERGED (inert), a non-finite one is BREAKDOWN
    before the first step.
    """
    z = precond(r)
    rz = (r * z).sum(0)
    nrm = torch.linalg.vector_norm(r, dim=0)
    bnorm = torch.where(nrm == 0, 1.0, nrm)
    relres = nrm / bnorm
    finite = torch.isfinite(relres) & torch.isfinite(rz)
    active = (relres >= rtol) & finite
    status = torch.where(finite,
                         torch.where(relres < rtol, codes[CONVERGED],
                                     codes[RUNNING]),
                         codes[BREAKDOWN])
    return z, rz, bnorm, relres, active, status


def _status_codes(device) -> torch.Tensor:
    return torch.arange(len(STATUS_NAMES), dtype=torch.int32, device=device)


def _pcg_batched_device(spmv: Callable[[torch.Tensor], torch.Tensor],
                        precond: Callable[[torch.Tensor], torch.Tensor],
                        b: torch.Tensor,
                        rtol: float = 1e-7,
                        maxiter: int = 10_000,
                        record_history: bool = False,
                        divergence_factor: float | None = DIVERGENCE_FACTOR,
                        stagnation_window: int | None = STAGNATION_WINDOW):
    """Device core of ``pcg_batched``: tensors in, tensors out.

    Returns ``(x, iters, relres, n_steps, status, history)``; ``n_steps``
    is a host int, the rest are tensors on ``b``'s device.  Per-column
    health monitoring mirrors ``_pcg_device`` (see ``_batched_step``); a
    broken column deactivates with its terminal status while its healthy
    neighbours' float sequences stay bitwise untouched.
    """
    divergence_factor, stagnation_window = _monitor_defaults(
        maxiter, divergence_factor, stagnation_window)
    b = torch.as_tensor(b)
    if b.dim() == 1:
        raise ValueError(
            f"pcg_batched expects b of shape (n, B), got a 1-D vector of "
            f"shape {tuple(b.shape)}; a single RHS must be passed as a "
            f"one-column slab b[:, None] (B = 1), or use pcg")
    if b.dim() != 2:
        raise ValueError(f"pcg_batched expects b of shape (n, B), got "
                         f"{tuple(b.shape)}")
    nb = b.shape[1]
    codes = _status_codes(b.device)
    x = torch.zeros_like(b)
    r = b
    p, rz, bnorm, relres0, active, status = _init_columns(precond, r, rtol,
                                                          codes)
    iters = torch.zeros(nb, dtype=torch.int32, device=b.device)
    since = torch.zeros(nb, dtype=torch.int32, device=b.device)
    best = relres0
    if record_history:
        hist = torch.full((maxiter + 1, nb), float("nan"), dtype=b.dtype,
                          device=b.device)
        hist[0] = relres0
        lanes = torch.arange(nb, device=b.device)
    else:
        hist = torch.zeros((0, nb), dtype=b.dtype, device=b.device)

    step = 0
    while step < maxiter and bool(active.any().item()):
        (x, r, p, rz, best, since, status, ok, relres2,
         healthy) = _batched_step(spmv, precond, x, r, p, rz, active, best,
                                  since, bnorm, codes, status,
                                  divergence_factor, stagnation_window)
        iters = iters + ok.to(torch.int32)
        if record_history:
            # a column records its residual at row == its own iteration
            # count while it steps; stopped columns keep their NaN padding
            row = iters.long()
            hist[row, lanes] = torch.where(ok, relres2, hist[row, lanes])
        active = ok & (relres2 >= rtol) & healthy
        step += 1
    relres = torch.linalg.vector_norm(r, dim=0) / bnorm
    # columns still RUNNING ended healthily: converged or out of budget
    status = torch.where(status == RUNNING,
                         torch.where(relres < rtol, codes[CONVERGED],
                                     codes[MAXITER]),
                         status)
    return x, iters, relres, step, status, hist


def pcg_batched(spmv: Callable[[torch.Tensor], torch.Tensor],
                precond: Callable[[torch.Tensor], torch.Tensor],
                b: torch.Tensor,
                rtol: float = 1e-7,
                maxiter: int = 10_000,
                record_history: bool = False,
                divergence_factor: float | None = DIVERGENCE_FACTOR,
                stagnation_window: int | None = STAGNATION_WINDOW
                ) -> BatchedPCGResult:
    """PCG over B right-hand sides in one loop.

    ``spmv`` and ``precond`` map (n, B) -> (n, B) column-wise (e.g.
    ``spmv_sell_batched`` and ``RoundMajorPreconditioner.apply_batched``).
    A column whose relative residual drops below ``rtol`` gets
    ``alpha = beta = 0`` from then on and its state is selected unchanged,
    so each column performs the arithmetic of a single-RHS ``pcg`` on that
    column up to reduction order, and the per-RHS iteration counts match
    the single-RHS counts.  The loop runs until every column has stopped
    (or ``maxiter``).  Per-column termination is in ``result.status``.
    """
    x, iters, relres, step, status, hist = _pcg_batched_device(
        spmv, precond, b, rtol=rtol, maxiter=maxiter,
        record_history=record_history, divergence_factor=divergence_factor,
        stagnation_window=stagnation_window)
    relres = relres.cpu().numpy()
    return BatchedPCGResult(x=x.cpu().numpy(),
                            iterations=iters.cpu().numpy(), relres=relres,
                            converged=relres < rtol, n_steps=step,
                            history=hist.cpu().numpy(),
                            status=status.cpu().numpy())


# ---------------------------------------------------------------------------
# Slab PCG: quantum-stepped batched PCG with slot-level entry/retirement.
#
# The serving layer (repro_torch.serve) keeps B independent PCG solves
# resident in one (m, B) slab and advances them at most ``quantum`` loop
# trips per dispatch.  Between dispatches the host retires finished columns
# and packs fresh right-hand sides into the freed slots; ``fresh`` tells the
# next dispatch which columns to (re)initialize.  Continuing columns pass
# through every select untouched, so dispatch boundaries do not perturb
# their float sequences.
# ---------------------------------------------------------------------------


class SlabState(NamedTuple):
    """Device-side carry of a resident PCG slab ((m, B) state vectors).

    ``fresh[j]`` marks column j for (re)initialization at the next dispatch:
    its ``r`` must already hold the embedded RHS (or zeros for an empty
    slot -- a zero residual initializes inert).  ``status[j]`` is RUNNING
    while the column iterates and definite once it stops.
    ``best``/``since_best`` carry the divergence/stagnation monitor across
    dispatches.  ``_pcg_slab_device`` never writes into the tensors of the
    state it is given; it returns a new state.
    """
    x: torch.Tensor        # (m, B) iterates
    r: torch.Tensor        # (m, B) residuals (RHS for fresh columns)
    p: torch.Tensor        # (m, B) search directions
    rz: torch.Tensor       # (B,)   carried (r, z) inner products
    bnorm: torch.Tensor    # (B,)   ||b|| per column (1.0 for zero columns)
    active: torch.Tensor   # (B,)   still iterating
    iters: torch.Tensor    # (B,)   per-column iteration counts (int32)
    relres: torch.Tensor   # (B,)   last relative residual norms
    fresh: torch.Tensor    # (B,)   initialize at next dispatch entry
    status: torch.Tensor   # (B,)   per-column termination codes (int32)
    best: torch.Tensor     # (B,)   best relres so far (monitor carry)
    since_best: torch.Tensor  # (B,) iterations since best improved (int32)


def _pcg_slab_device(spmv: Callable[[torch.Tensor], torch.Tensor],
                     precond: Callable[[torch.Tensor], torch.Tensor],
                     state: SlabState,
                     rtol: float = 1e-7,
                     maxiter: int = 10_000,
                     quantum: int = 16,
                     divergence_factor: float | None = DIVERGENCE_FACTOR,
                     stagnation_window: int | None = STAGNATION_WINDOW
                     ) -> tuple[SlabState, int]:
    """Advance a PCG slab by at most ``quantum`` iterations.

    Columns with ``fresh`` set start here from their ``r``, exactly as
    ``_pcg_batched_device`` starts a column (a non-finite RHS is BREAKDOWN,
    a zero RHS CONVERGED and inert).  The loop body is
    ``_pcg_batched_device``'s, plus a per-column ``iters < maxiter`` cutoff
    (columns enter the slab at different times).  Returns
    ``(new_state, steps)``: ``fresh`` cleared, every inactive column's
    ``status`` definite, ``steps`` the loop trips taken (a host int).
    """
    divergence_factor, stagnation_window = _monitor_defaults(
        maxiter, divergence_factor, stagnation_window)
    (x, r, p, rz, bnorm, active, iters, relres, fresh, status, best,
     since_best) = state
    codes = _status_codes(r.device)

    # start the fresh columns; continuing columns pass through every
    # select untouched (their precond/dot results are computed and dropped)
    z, rz0, bnorm0, relres0, active0, status0 = _init_columns(
        precond, r, rtol, codes)
    fr = fresh[None, :]
    x = torch.where(fr, 0.0, x)
    p = torch.where(fr, z, p)
    rz = torch.where(fresh, rz0, rz)
    bnorm = torch.where(fresh, bnorm0, bnorm)
    iters = torch.where(fresh, 0, iters)
    relres = torch.where(fresh, relres0, relres)
    active = torch.where(fresh, active0, active)
    status = torch.where(fresh, status0, status)
    best = torch.where(fresh, relres0, best)
    since_best = torch.where(fresh, 0, since_best)

    step = 0
    while step < quantum and bool(active.any().item()):
        (x, r, p, rz, best, since_best, status, ok, relres2,
         healthy) = _batched_step(spmv, precond, x, r, p, rz, active, best,
                                  since_best, bnorm, codes, status,
                                  divergence_factor, stagnation_window)
        iters = iters + ok.to(torch.int32)
        relres = torch.where(ok, relres2, relres)
        active = ok & (relres2 >= rtol) & (iters < maxiter) & healthy
        step += 1
    # every inactive column leaves with a definite status: terminal codes
    # set in the loop are kept; an inactive RUNNING column ended healthily
    status = torch.where(active | (status != RUNNING), status,
                         torch.where(relres < rtol, codes[CONVERGED],
                                     codes[MAXITER]))
    out = SlabState(x=x, r=r, p=p, rz=rz, bnorm=bnorm, active=active,
                    iters=iters, relres=relres,
                    fresh=torch.zeros_like(fresh), status=status, best=best,
                    since_best=since_best)
    return out, step
