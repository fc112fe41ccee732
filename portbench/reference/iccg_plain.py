"""Plain ICCG in ``torch`` on the CPU, float64: IC(0) of A in a given
ordering, factored row by row; its apply by sparse forward and backward
substitution; and textbook preconditioned CG with the program's stopping
rule and status names.

The same mathematics as the program's plan by another route: no coloring,
no rounds, no packed tables, no kernels.  It is for tests at small n; the
comparison that decides a run's ``correct`` is ``residual.py``.

``perm[i]`` is the position of unknown i in the ordering (any distinct
integers: the program's plan gives positions among its padded unknowns).
The factor is IC(0) of P A P^T on A's stored pattern:

    L[i, k] = (A[i, k] - sum_{j < k} L[i, j] L[k, j]) / L[k, k]   (k < i)
    L[i, i] = sqrt(A[i, i] - sum_{j < i} L[i, j]^2)

over j in the pattern of both rows.  The solve starts from x = 0 and stops
when the recursive residual ||r|| / ||b|| falls below ``rtol``
(CONVERGED), after ``maxiter`` iterations (MAXITER), or on p^T A p <= 0
or a non-finite residual (BREAKDOWN).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

F64 = torch.float64


@dataclasses.dataclass
class Factor:
    """The IC(0) factor in the ordering: L's strict lower rows as CSR
    (``indptr``, ``indices``, ``values``; positions in the ordering), its
    diagonal, and the ordering (``order[p]`` is the unknown at position
    p)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    diag: torch.Tensor
    order: torch.Tensor

    def row(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.values[lo:hi]


def ordered(a: sp.spmatrix, perm) -> tuple[sp.csr_matrix, np.ndarray]:
    """P A P^T in CSR with sorted indices, and the ordering."""
    order = np.argsort(np.asarray(perm), kind="stable")
    b = sp.csr_matrix(a)[order][:, order].tocsr()
    b.sort_indices()
    return b, order


def ic0(a: sp.spmatrix, perm) -> Factor:
    """IC(0) of A in the ordering ``perm``, row by row.  Raises
    ValueError on a pivot that is not positive."""
    b, order = ordered(a, perm)
    n = b.shape[0]
    indptr = torch.as_tensor(b.indptr, dtype=torch.int64)
    indices = torch.as_tensor(b.indices, dtype=torch.int64)
    data = torch.as_tensor(b.data, dtype=F64)
    rows_ptr, rows_idx, rows_val = [0], [], []
    diag = torch.zeros(n, dtype=F64)
    w = torch.zeros(n, dtype=F64)          # row i of L, as it is computed
    for i in range(n):
        cols = indices[indptr[i]:indptr[i + 1]]
        vals = data[indptr[i]:indptr[i + 1]]
        lower = cols < i
        lc = cols[lower]
        w[lc] = vals[lower]
        for k in lc.tolist():
            kc, kv = rows_idx[k], rows_val[k]
            w[k] = (w[k] - torch.dot(w[kc], kv)) / diag[k]
        li = w[lc]
        pivot = vals[cols == i].sum() - torch.dot(li, li)
        if not pivot > 0:
            raise ValueError(f"IC(0) pivot {float(pivot)} at position {i}")
        diag[i] = torch.sqrt(pivot)
        rows_idx.append(lc)
        rows_val.append(li.clone())
        rows_ptr.append(rows_ptr[-1] + lc.numel())
        w[lc] = 0.0
    return Factor(torch.tensor(rows_ptr, dtype=torch.int64),
                  torch.cat(rows_idx) if rows_idx else
                  torch.zeros(0, dtype=torch.int64),
                  torch.cat(rows_val) if rows_val else
                  torch.zeros(0, dtype=F64),
                  diag, torch.as_tensor(order, dtype=torch.int64))


def apply(f: Factor, r: torch.Tensor) -> torch.Tensor:
    """z = (P^T L L^T P)^{-1} r: r and z in A's own ordering."""
    n = f.diag.numel()
    y = r[f.order].clone()
    for i in range(n):                      # L y = P r
        c, v = f.row(i)
        y[i] = (y[i] - torch.dot(v, y[c])) / f.diag[i]
    for i in range(n - 1, -1, -1):          # L^T z = y, column by column
        y[i] = y[i] / f.diag[i]
        c, v = f.row(i)
        y[c] -= v * y[i]
    z = torch.empty_like(y)
    z[f.order] = y
    return z


@dataclasses.dataclass
class Result:
    x: np.ndarray
    iterations: int
    relres: float
    status: str


def pcg(a: sp.spmatrix, b, f: Factor, rtol: float = 1e-7,
        maxiter: int = 10_000) -> Result:
    """Preconditioned CG on A x = b from x = 0 with the preconditioner
    ``f``: alpha = (r, z) / (p, A p), beta = (r', z') / (r, z)."""
    a = sp.coo_matrix(a)
    rows, cols = (torch.as_tensor(x, dtype=torch.int64)
                  for x in (a.row, a.col))
    vals = torch.as_tensor(a.data, dtype=F64)

    def spmv(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(v).index_add_(0, rows, vals * v[cols])

    b = torch.as_tensor(np.asarray(b), dtype=F64)
    bnorm = torch.linalg.vector_norm(b)
    bnorm = bnorm if bnorm > 0 else torch.ones((), dtype=F64)
    x = torch.zeros_like(b)
    r = b.clone()
    z = apply(f, r)
    p = z.clone()
    rz = torch.dot(r, z)
    relres = float(torch.linalg.vector_norm(r) / bnorm)
    it, status = 0, "RUNNING"
    while relres >= rtol and it < maxiter:
        ap = spmv(p)
        pap = torch.dot(p, ap)
        alpha = rz / pap
        r2 = r - alpha * ap
        z = apply(f, r2)
        rz2 = torch.dot(r2, z)
        rnorm = torch.linalg.vector_norm(r2)
        if not (pap > 0 and torch.isfinite(rnorm) and torch.isfinite(rz2)):
            status = "BREAKDOWN"          # x stays the last finite iterate
            break
        x = x + alpha * p
        p = z + (rz2 / rz) * p
        r, rz = r2, rz2
        relres = float(rnorm / bnorm)
        it += 1
    if status == "RUNNING":
        status = "CONVERGED" if relres < rtol else "MAXITER"
    return Result(x.numpy(), it, relres, status)
