# Copy of repro/core/ic0.py (numpy/scipy only).  The port keeps its own copy
# because importing the reference package loads JAX; the two stay identical
# so setup products are bitwise-equal (tests/test_torch_setup.py).
"""Shifted IC(0) — zero-fill incomplete Cholesky factorization (paper §2).

A ~= L L^T where L is lower triangular with the same nonzero pattern as the
lower triangular part of A.  The *shifted* variant factorizes

    A + alpha * diag(A)

(the diagonal scaled by ``1 + alpha``); this is the paper's §5.1 shifted IC
(alpha = 0.3 for Ieej) written without the diagonal scaling: factorizing the
diagonally scaled matrix  D^{-1/2} A D^{-1/2} + alpha I  yields exactly
``D^{-1/2} L`` where ``L`` is the factor of ``A + alpha diag(A)``, so the two
formulations produce the same preconditioned operator up to a symmetric
diagonal similarity (pinned by tests/test_setup_plan.py on the Ieej
generator).  The shift guards against breakdown on semi-definite systems.

Two implementations of the same factorization:

  * ``ic0`` — the sequential up-looking row loop (the semantics oracle).
  * ``ic0_rounds`` / ``ic0_structure`` + ``ic0_refactor`` — the
    round-parallel setup pipeline.  Rows within a multi-color round are
    mutually independent (the same property the triangular solve exploits),
    so every dependency of a row's factorization — its lower neighbors and
    their rows — lives in a strictly earlier round.  The factorization
    therefore runs as ``sum_s max_rowlen(round_s)`` vectorized numpy steps:
    all rows of a round advance one entry position per step as one batch.
    ``ic0_structure`` does the pattern-only analysis once; ``ic0_refactor``
    re-runs just the numeric phase (the factor-once / solve-many workload of
    ``core.plan.SolverPlan``).

Host-side setup code (numpy; one-time cost amortized over the CG
iterations), exactly as the reordering itself.  Factors are returned in CSR
so the SELL packing (``sell.py``) can slice them per HBMC step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .graph import ragged_arange


class FactorBreakdownError(RuntimeError):
    """The IC(0) factorization broke down (clamped pivots or non-finite
    factor data) and the caller's ``on_breakdown`` policy forbids using the
    degraded factor.  Carries ``clamped_pivots`` and the ``shift_schedule``
    of attempted (shift, clamped_pivots) pairs when raised from the plan's
    escalation loop."""

    def __init__(self, msg: str, clamped_pivots: int = 0,
                 shift_schedule: list | None = None):
        super().__init__(msg)
        self.clamped_pivots = clamped_pivots
        self.shift_schedule = shift_schedule or []


def ic0(a: sp.spmatrix, shift: float = 0.0, breakdown_eps: float = 1e-13
        ) -> sp.csr_matrix:
    """Return L (CSR, lower triangular incl. diagonal) with A ~= L L^T.

    Row-oriented up-looking factorization restricted to pattern(tril(A)).
    Sorted-merge intersection of row patterns keeps it O(sum row^2) which is
    fine for the stencil-type matrices used in the paper.  ``shift`` applies
    the diagonal scaling ``a_ii -> a_ii * (1 + shift)`` before factorizing
    (see the module docstring for the relation to the paper's diagonally
    scaled formulation).

    The returned CSR carries ``clamped_pivots`` — how many diagonal pivots
    hit the ``breakdown_eps`` guard (a nonzero count means the factor is
    degraded: A was not positive definite enough for IC(0) at this shift).
    A NaN pivot is NOT a clamp (NaN comparisons are false; it propagates
    into the factor data, detectable via ``np.isfinite``) — the
    round-parallel path behaves identically.
    """
    a = sp.csr_matrix(a).astype(np.float64)
    n = a.shape[0]
    low = sp.tril(a, format="csr")
    low.sort_indices()
    indptr, indices, data = low.indptr, low.indices, low.data.copy()
    if shift != 0.0:
        diag = a.diagonal()
        for i in range(n):
            last = indptr[i + 1] - 1
            # diagonal is the last entry of the sorted lower row
            data[last] = diag[i] * (1.0 + shift)

    # L rows stored as (col array, val array), built in place over `data`
    lcols: list[np.ndarray] = [None] * n  # type: ignore[list-item]
    lvals: list[np.ndarray] = [None] * n  # type: ignore[list-item]
    diag_l = np.empty(n, dtype=np.float64)
    clamped = 0

    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        vals_i = data[s:e]
        if cols_i[-1] != i:
            raise ValueError(f"missing diagonal in row {i}")
        row_vals = np.empty(e - s, dtype=np.float64)
        for t in range(e - s):
            j = cols_i[t]
            v = vals_i[t]
            # v -= sum_k l_ik * l_jk over shared k < j (merge of sorted rows)
            cj, vj = (lcols[j], lvals[j]) if j < i else (cols_i[:t], row_vals[:t])
            ci, vi = cols_i[:t], row_vals[:t]
            pi = pj = 0
            acc = 0.0
            li, lj = len(ci), len(cj)
            while pi < li and pj < lj:
                a_, b_ = ci[pi], cj[pj]
                if a_ == b_:
                    if a_ >= j:
                        break
                    acc += vi[pi] * vj[pj]
                    pi += 1; pj += 1
                elif a_ < b_:
                    pi += 1
                else:
                    pj += 1
            v -= acc
            if j < i:
                row_vals[t] = v / diag_l[j]
            else:  # diagonal
                if v <= breakdown_eps:
                    v = breakdown_eps  # breakdown guard
                    clamped += 1
                row_vals[t] = np.sqrt(v)
                diag_l[i] = row_vals[t]
        lcols[i] = cols_i
        lvals[i] = row_vals
        data[s:e] = row_vals

    l = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    l.clamped_pivots = clamped
    return l


# ---------------------------------------------------------------------------
# Round-parallel IC(0): symbolic analysis once, vectorized numeric per call.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IC0Structure:
    """Pattern-only analysis of a round-parallel IC(0) factorization.

    The factorization is scheduled as ``n_steps`` sequential *steps*; step
    ``(round s, in-row offset t)`` computes entry ``t`` of every row of
    round ``s`` as one numpy batch.  Entry values within a row depend on the
    row's earlier entries (smaller ``t``, earlier step) and on rows of
    strictly earlier rounds — both finished by construction, which
    ``ic0_structure`` validates.

    ``steps[s]`` is the fully precomputed work list of step ``s``:
    ``(pos, n_off, dep_off, rows_di, pair_ab, n_pair, pair_tgt)`` where
    ``pos`` holds the entry positions computed this step (off-diagonals
    first, then diagonals — ``n_off`` splits them), ``dep_off`` the row
    whose diagonal divides each off-diagonal, ``rows_di`` the rows whose
    diagonal is produced, and ``pair_ab`` the inner-product operand
    positions (``n_pair`` l_ik positions followed by ``n_pair`` matching
    l_jk positions; ``pair_tgt`` the target entry, local within ``pos``),
    sorted per target by ascending ``k`` so the accumulation order — and
    hence the floats — match the sequential ``ic0`` merge exactly.
    """
    n: int
    n_steps: int
    indptr: np.ndarray       # lower pattern (incl. diagonal, sorted)
    indices: np.ndarray
    steps: list

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def n_pairs(self) -> int:
        return sum(s[5] for s in self.steps)


def ic0_structure(a: sp.spmatrix, rounds: list[np.ndarray]) -> IC0Structure:
    """Analyze pattern(tril(A)) for the round-parallel factorization.

    ``rounds`` must partition the rows in execution order with all lower
    neighbors of a row in strictly earlier rounds (exactly the property the
    MC/BMC/HBMC forward rounds provide) — validated here, ValueError
    otherwise.
    """
    a = sp.csr_matrix(a)
    n = a.shape[0]
    low = sp.tril(a, format="csr")
    low.sort_indices()
    indptr, indices = low.indptr, low.indices.astype(np.int64)
    lens = np.diff(indptr)
    nnz = int(indices.size)
    if not np.array_equal(indices[indptr[1:] - 1], np.arange(n)):
        missing = np.nonzero(indices[indptr[1:] - 1] != np.arange(n))[0]
        raise ValueError(f"missing diagonal in row {missing[0]}")

    round_id = np.full(n, -1, dtype=np.int64)
    total = 0
    for s, r in enumerate(rounds):
        round_id[r] = s
        total += len(r)
    if total != n or (round_id < 0).any():
        raise ValueError("rounds must partition the rows exactly once")
    row_of = np.repeat(np.arange(n), lens)
    strict = indices < row_of
    if not np.all(round_id[indices[strict]] < round_id[row_of[strict]]):
        raise ValueError("rounds are not dependency-ordered: some row has a "
                         "lower neighbor in the same or a later round")

    # --- step schedule: step(entry) = step_base[round(row)] + offset -------
    maxlen = np.fromiter((lens[r].max() if len(r) else 0 for r in rounds),
                         dtype=np.int64, count=len(rounds))
    step_base = np.concatenate([[0], np.cumsum(maxlen)])
    n_steps = int(step_base[-1])
    offs = ragged_arange(lens)
    step_of = step_base[round_id[row_of]] + offs
    isdiag = indices == row_of

    # entries ordered by (step, off-diagonals-before-diagonals, position):
    # single composite key + stable sort (position order is preserved)
    ent_order = np.argsort((step_of * 2 + isdiag).astype(np.int32),
                           kind="stable")
    ent_counts = np.bincount(step_of, minlength=n_steps)
    ent_indptr = np.concatenate([[0], np.cumsum(ent_counts)])
    # local index of every entry position within its step
    local_of_pos = np.empty(nnz, dtype=np.int32)
    local_of_pos[ent_order] = ragged_arange(ent_counts, dtype=np.int32)

    # --- inner-product pairs: for entry (i, j) at offset t, every shared
    # k < j contributes l_ik (offset s2 < t of row i) * l_jk (row j).
    # candidates: a target at CSR position p (in-row offset t) pairs with
    # its row's earlier entries — the contiguous positions p-t .. p-1.  One
    # ragged enumeration replaces any per-(t, s2) Python loop, int32 when
    # the candidate count allows (halves the memory traffic), int64 beyond;
    # enumerating the targets in STEP-MAJOR order (ent_order) makes the
    # surviving pairs come out already grouped by step — target-major,
    # sources ascending, i.e. the one order that matters: pairs of any
    # single target stay k-ascending, the sequential merge order — so no
    # post-hoc sort is needed.
    n_cand = int(offs.sum())
    if n_cand:
        cdt = (np.int32 if max(n_cand, nnz) < np.iinfo(np.int32).max
               else np.int64)
        entc = ent_order.astype(cdt)
        offs_sm = offs.astype(cdt)[ent_order]        # offsets, step-major
        pt = np.repeat(entc, offs_sm)
        seq = ragged_arange(offs_sm, dtype=cdt)
        pa = np.repeat(entc - offs_sm, offs_sm) + seq
        # (j, k) -> position lookup: one binary search over the globally
        # sorted key row*n + col
        key_dt = np.int32 if n * n < np.iinfo(np.int32).max else np.int64
        idxk = indices.astype(key_dt)
        nk = key_dt(n)
        keys = row_of.astype(key_dt) * nk + idxk
        key = idxk[pt] * nk + idxk[pa]
        q = np.searchsorted(keys, key).astype(cdt)
        ok = np.flatnonzero((q < nnz)
                            & (keys[np.minimum(q, nnz - 1)] == key))
        pt, pa, pb = pt[ok], pa[ok], q[ok]
        pair_counts = np.bincount(step_of[pt], minlength=n_steps)
    else:
        pt = pa = pb = np.zeros(0, dtype=np.int64)
        pair_counts = np.zeros(n_steps, dtype=np.int64)
    pair_indptr = np.concatenate([[0], np.cumsum(pair_counts)])
    pair_tgt = local_of_pos[pt]

    # pa/pb interleaved per step ([pa_s | pb_s] at [2*p0, 2*p1)) so the
    # numeric sweep gathers both product operands with ONE fancy index per
    # step; built with a single ragged scatter, sliced as views below
    n_pairs = len(pt)
    pab = np.empty(2 * n_pairs, dtype=pt.dtype if n_pairs else np.int64)
    if n_pairs:
        rag = ragged_arange(pair_counts)
        base = np.repeat(2 * pair_indptr[:-1], pair_counts) + rag
        pab[base] = pa
        pab[base + np.repeat(pair_counts, pair_counts)] = pb

    # --- assemble the per-step work lists ----------------------------------
    ent_pos = ent_order
    ent_dep = indices[ent_order].astype(np.int32)
    off_counts = np.bincount(step_of[~isdiag], minlength=n_steps).tolist()
    ei = ent_indptr.tolist()
    pi = pair_indptr.tolist()
    steps = []
    for s in range(n_steps):
        e0, e1 = ei[s], ei[s + 1]
        n_off = off_counts[s]
        p0, p1 = pi[s], pi[s + 1]
        if p1 > p0:
            steps.append((ent_pos[e0:e1], n_off, ent_dep[e0:e0 + n_off],
                          ent_dep[e0 + n_off:e1], pab[2 * p0:2 * p1],
                          p1 - p0, pair_tgt[p0:p1]))
        else:
            steps.append((ent_pos[e0:e1], n_off, ent_dep[e0:e0 + n_off],
                          ent_dep[e0 + n_off:e1], None, 0, None))

    return IC0Structure(n=n, n_steps=n_steps, indptr=indptr, indices=indices,
                        steps=steps)


def ic0_refactor(st: IC0Structure, a: sp.spmatrix, shift: float = 0.0,
                 breakdown_eps: float = 1e-13) -> sp.csr_matrix:
    """Numeric-only factorization of a matrix matching ``st``'s pattern.

    This is the refactor path of ``SolverPlan``: same sparsity structure,
    new values — no ordering, no symbolic analysis, just the vectorized
    per-step sweep.  Raises ValueError if the pattern differs.

    Like ``ic0``, the returned CSR carries ``clamped_pivots`` (NaN pivots
    excluded — ``v <= eps`` is false for NaN in both paths, so the
    sequential and round-parallel counts agree exactly).
    """
    a = sp.csr_matrix(a)
    low = sp.tril(a, format="csr")
    low.sort_indices()
    if (low.shape[0] != st.n
            or not np.array_equal(low.indptr, st.indptr)
            or not np.array_equal(low.indices, st.indices)):
        raise ValueError("matrix sparsity pattern differs from the analyzed "
                         "structure; rebuild the plan/structure instead")
    data = low.data.astype(np.float64, copy=True)
    if shift != 0.0:
        dpos = st.indptr[1:] - 1
        data[dpos] = data[dpos] * (1.0 + shift)

    diag_l = np.empty(st.n, dtype=np.float64)
    clamped = 0
    bincount, sqrt, maximum = np.bincount, np.sqrt, np.maximum
    for pos, n_off, dep_off, rows_di, pab, npair, tgt in st.steps:
        v = data[pos]
        if pab is not None:
            # bincount accumulates in input order == (target, k) sorted, so
            # the partial sums match the sequential merge bit for bit
            g = data[pab]
            v = v - bincount(tgt, weights=g[:npair] * g[npair:],
                             minlength=len(pos))
        # breakdown guard: v <= eps -> eps (maximum is the same map; NaN
        # passes through both — `<=` is false, maximum propagates it)
        vd = v[n_off:]
        clamped += int(np.count_nonzero(vd <= breakdown_eps))
        sq = sqrt(maximum(vd, breakdown_eps))
        data[pos[:n_off]] = v[:n_off] / diag_l[dep_off]
        data[pos[n_off:]] = sq
        diag_l[rows_di] = sq

    l = sp.csr_matrix((data, st.indices.copy(), st.indptr.copy()),
                      shape=(st.n, st.n))
    l.clamped_pivots = clamped
    return l


def ic0_rounds(a: sp.spmatrix, rounds: list[np.ndarray], shift: float = 0.0,
               breakdown_eps: float = 1e-13) -> sp.csr_matrix:
    """Round-parallel IC(0): ``ic0`` computed as vectorized per-round batches.

    Produces the same factor as the sequential ``ic0`` (same accumulation
    order per entry — tested to tight tolerance across all orderings) in
    ``sum_s max_rowlen(round_s)`` numpy steps instead of a per-entry Python
    loop.  ``rounds`` are the forward rounds of any dependency-ordered
    multi-color ordering (``sell.rounds_mc`` / ``rounds_bmc`` /
    ``rounds_hbmc`` / ``rounds_natural``).
    """
    st = ic0_structure(a, rounds)
    return ic0_refactor(st, a, shift=shift, breakdown_eps=breakdown_eps)


def ic0_error(a: sp.spmatrix, l: sp.csr_matrix) -> float:
    """|| proj_pattern(A - L L^T) ||_F / ||A||_F — zero for exact IC(0) on the
    pattern (sanity check used by tests)."""
    a = sp.csr_matrix(a).astype(np.float64)
    prod = (l @ l.T).tocsr()
    pattern = (a != 0)
    diff = (a - prod.multiply(pattern))
    return float(sp.linalg.norm(diff) / sp.linalg.norm(a))


def sequential_ic_solve(l: sp.csr_matrix, r: np.ndarray) -> np.ndarray:
    """Oracle preconditioner application z = (L L^T)^{-1} r, sequential scipy."""
    y = sp.linalg.spsolve_triangular(l.tocsr(), r, lower=True)
    z = sp.linalg.spsolve_triangular(l.T.tocsr(), y, lower=False)
    return z
