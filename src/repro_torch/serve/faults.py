"""Seeded fault injection for the serving simulation tier.

Port of ``repro.serve.faults``: the same seeded traces (numpy only), built
on the port's own ``core.matrices.laplace_2d``.

``FaultInjector`` generates deterministic adversarial request streams —
malformed right-hand sides (NaN/Inf/zero), matrices the ICCG method is not
entitled to (indefinite, semi-definite, near-singular, NaN-contaminated),
refactor-under-load value changes, and deadline storms — and drives them
into a :class:`repro_torch.serve.SolverService` under a virtual clock.

Every fault kind carries the set of statuses a robust service may resolve
it to.  The harness contract (pinned by tests/test_torch_serve.py):

* every submitted request terminates with a *definite* status from its
  kind's expected set — no silent NaN solutions, no hung slots;
* the service stays live throughout — healthy requests interleaved with
  faults still converge to their bitwise oracle solutions;
* ``QueueFullError`` sheds load instead of corrupting state.

Everything is seeded: the same (seed, n_requests) trace reproduces
bit-for-bit, which is what makes the tier CI-able.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..core.matrices import laplace_2d

from .solver import QueueFullError, SolverService

#: All injectable fault kinds, in trace-sampling order.
FAULT_KINDS = ("healthy", "zero_rhs", "nan_rhs", "inf_rhs", "indefinite",
               "semidefinite", "near_singular", "nan_matrix",
               "value_change", "deadline")

#: Statuses a robust service may resolve each kind to.  The degenerate
#: spectra (indefinite / semi-definite / near-singular) admit several
#: legitimate terminal diagnoses — which one fires depends on rtol,
#: maxiter and the monitor windows — but all are definite and none is a
#: silent NaN.
EXPECTED_STATUSES = {
    "healthy": frozenset({"CONVERGED"}),
    "zero_rhs": frozenset({"CONVERGED"}),
    "nan_rhs": frozenset({"BREAKDOWN"}),
    "inf_rhs": frozenset({"BREAKDOWN"}),
    "indefinite": frozenset({"BREAKDOWN", "DIVERGED", "STAGNATED",
                             "MAXITER", "CONVERGED"}),
    "semidefinite": frozenset({"BREAKDOWN", "DIVERGED", "STAGNATED",
                               "MAXITER", "CONVERGED"}),
    "near_singular": frozenset({"STAGNATED", "MAXITER", "CONVERGED"}),
    "nan_matrix": frozenset({"BREAKDOWN"}),
    "value_change": frozenset({"CONVERGED"}),
    "deadline": frozenset({"DEADLINE", "CONVERGED"}),
}


def _with_diagonal(a: sp.csr_matrix, new_diag: np.ndarray) -> sp.csr_matrix:
    """``a`` with its diagonal replaced, as a canonical duplicate-free CSR
    (sparse addition merges entries; ``lil.setdiag`` would leave duplicate
    diagonal entries behind, which corrupts CSR consumers downstream)."""
    d = sp.diags(np.asarray(new_diag) - a.diagonal())
    out = sp.csr_matrix(a + d)
    out.sum_duplicates()
    out.sort_indices()
    return out


def indefinite_matrix(n_side: int = 6, shift: float = 1.0) -> sp.csr_matrix:
    """SPD 5-point Laplacian made indefinite by a diagonal downshift
    exceeding its smallest eigenvalue (diagonals stay positive, so the
    factorization proceeds into clamps rather than failing structurally).
    """
    a = laplace_2d(n_side, n_side)
    return _with_diagonal(a, a.diagonal() - shift)


def semidefinite_matrix(n_side: int = 6) -> sp.csr_matrix:
    """Singular PSD matrix: the Laplacian with exact zero row sums (pure
    Neumann — constants span the kernel)."""
    a = laplace_2d(n_side, n_side)
    offdiag = np.asarray(a.sum(axis=1)).ravel() - a.diagonal()
    return _with_diagonal(a, -offdiag)


def near_singular_matrix(n_side: int = 6,
                         eps: float = 1e-10) -> sp.csr_matrix:
    """SPD but within ``eps`` of singular: the semi-definite matrix plus
    ``eps`` on the diagonal (condition number ~ 1/eps)."""
    a = semidefinite_matrix(n_side)
    return _with_diagonal(a, a.diagonal() + eps)


@dataclasses.dataclass
class FaultPlan:
    """One adversarial request: what to submit and what may come back."""
    kind: str
    a: sp.csr_matrix
    b: np.ndarray
    timeout: float | None
    expected: frozenset


class FaultInjector:
    """Deterministic adversarial trace generator over one base problem.

    All kinds share the healthy base matrix's size ``n`` (and, where the
    kind is an RHS fault or a value change, its sparsity pattern too — the
    worst case for the plan cache, which must keep the healthy entries
    clean while the poisoned values fail).
    """

    def __init__(self, seed: int = 0, n_side: int = 6,
                 kinds: tuple = FAULT_KINDS,
                 deadline_timeout: float = 0.02):
        unknown = set(kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")
        self.rng = np.random.default_rng(seed)
        self.kinds = tuple(kinds)
        self.deadline_timeout = float(deadline_timeout)
        self.base = laplace_2d(n_side, n_side)
        self.n = self.base.shape[0]
        # same pattern, scaled values: the refactor-under-load kind
        self.base_scaled = self.base.copy()
        self.base_scaled.data = self.base_scaled.data * 2.0
        # same pattern, one NaN value: poisons only its own values_fp
        self.base_nan = self.base.copy()
        self.base_nan.data = self.base_nan.data.copy()
        self.base_nan.data[0] = np.nan
        self.indefinite = indefinite_matrix(n_side)
        self.semidefinite = semidefinite_matrix(n_side)
        self.near_singular = near_singular_matrix(n_side)

    def _rhs(self) -> np.ndarray:
        return self.rng.standard_normal(self.n)

    def make(self, kind: str) -> FaultPlan:
        """One seeded request of the given kind."""
        a, b, timeout = self.base, self._rhs(), None
        if kind == "zero_rhs":
            b = np.zeros(self.n)
        elif kind == "nan_rhs":
            b[self.rng.integers(self.n)] = np.nan
        elif kind == "inf_rhs":
            b[self.rng.integers(self.n)] = np.inf
        elif kind == "indefinite":
            a = self.indefinite
        elif kind == "semidefinite":
            a = self.semidefinite
        elif kind == "near_singular":
            a = self.near_singular
        elif kind == "nan_matrix":
            a = self.base_nan
        elif kind == "value_change":
            a = self.base_scaled
        elif kind == "deadline":
            timeout = self.deadline_timeout
        elif kind != "healthy":
            raise ValueError(f"unknown fault kind {kind!r}")
        return FaultPlan(kind=kind, a=a, b=b, timeout=timeout,
                         expected=EXPECTED_STATUSES[kind])

    def trace(self, n_requests: int) -> list:
        """A seeded mixed trace of ``n_requests`` fault plans."""
        picks = self.rng.integers(len(self.kinds), size=n_requests)
        return [self.make(self.kinds[int(i)]) for i in picks]

    def inject(self, svc: SolverService, n_requests: int,
               spacing: float = 0.0
               ) -> tuple[dict, list]:
        """Submit a seeded trace into ``svc``; returns ``(rids, shed)``.

        ``rids`` maps request id -> :class:`FaultPlan`; ``shed`` lists the
        plans refused with :class:`QueueFullError` (backpressure is a
        valid robustness outcome, not a failure).  ``spacing`` staggers
        arrivals on a simulated clock.
        """
        simulated = getattr(svc.clock, "simulated", False)
        rids: dict[int, FaultPlan] = {}
        shed: list[FaultPlan] = []
        t0 = svc.clock.now()
        for i, fp in enumerate(self.trace(n_requests)):
            arrival = t0 + i * spacing if (simulated and spacing) else None
            try:
                rid = svc.submit(fp.a, fp.b, arrival_time=arrival,
                                 timeout=fp.timeout)
            except QueueFullError:
                shed.append(fp)
                continue
            rids[rid] = fp
        return rids, shed
