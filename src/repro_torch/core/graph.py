# Copy of repro/core/graph.py (numpy/scipy only).  The port keeps its own copy
# because importing the reference package loads JAX; the two stay identical
# so setup products are bitwise-equal (tests/test_torch_setup.py).
"""Ordering-graph utilities for parallel orderings (paper §3).

The ordering graph of a symmetric sparse matrix A is the undirected adjacency
structure; an *ordering* directs every edge from the smaller to the larger
index.  Two orderings are equivalent (ER condition, eq. 3.5) iff they induce
the same directed graph, i.e. sgn(i1 - i2) == sgn(pi(i1) - pi(i2)) for every
edge (i1, i2).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def ragged_arange(counts: np.ndarray, dtype=np.int64) -> np.ndarray:
    """Segment-relative indices: ``[0..counts[0]), [0..counts[1]), ...``.

    The shared ragged-enumeration idiom of the vectorized setup pipeline
    (step packing, ELL scatters, round-parallel IC(0) candidates): one flat
    array holding, for every segment ``i``, the run ``0..counts[i]-1``.
    ``dtype`` must be able to hold ``counts.sum()``.
    """
    counts = np.asarray(counts, dtype=dtype)
    total = int(counts.sum())
    return (np.arange(total, dtype=dtype)
            - np.repeat(np.cumsum(counts) - counts, counts))


def symmetrize_pattern(a: sp.spmatrix) -> sp.csr_matrix:
    """Return the symmetrized (pattern-wise) CSR form of ``a``."""
    a = sp.csr_matrix(a)
    pattern = (a != 0).astype(np.int8)
    sym = ((pattern + pattern.T) != 0).astype(np.int8)
    sym.setdiag(0)
    sym.eliminate_zeros()
    return sp.csr_matrix(sym)


def adjacency_lists(a: sp.spmatrix) -> tuple[np.ndarray, np.ndarray]:
    """Return (indptr, indices) of the symmetrized off-diagonal adjacency."""
    sym = symmetrize_pattern(a)
    return sym.indptr, sym.indices


def check_er_condition(a: sp.spmatrix, perm_old_to_new: np.ndarray) -> bool:
    """Check the ER condition (eq. 3.5) of ``perm`` w.r.t. matrix ``a``.

    ``perm_old_to_new[i]`` is the new index pi(i) of old unknown i.
    Returns True iff the reordering is equivalent (preserves the ordering
    graph): for every edge (i1, i2), sgn(i1-i2) == sgn(pi(i1)-pi(i2)).
    """
    coo = sp.coo_matrix(symmetrize_pattern(a))
    i1, i2 = coo.row, coo.col
    mask = i1 != i2
    i1, i2 = i1[mask], i2[mask]
    p = np.asarray(perm_old_to_new)
    return bool(np.all(np.sign(i1 - i2) == np.sign(p[i1] - p[i2])))


def permute_system(
    a: sp.spmatrix, b: np.ndarray | None, perm_old_to_new: np.ndarray
) -> tuple[sp.csr_matrix, np.ndarray | None]:
    """Apply reordering: A_bar = P A P^T, b_bar = P b (eq. 3.3).

    With ``perm_old_to_new[i] = pi(i)``, row i of A becomes row pi(i) of
    A_bar.  scipy indexing wants the gather form new->old.
    """
    n = a.shape[0]
    p = np.asarray(perm_old_to_new)
    gather = np.empty(n, dtype=np.int64)  # gather[new] = old
    gather[p] = np.arange(n)
    a = sp.csr_matrix(a)
    a_bar = a[gather][:, gather].tocsr()
    b_bar = None if b is None else np.asarray(b)[gather]
    return a_bar, b_bar


def invert_perm(perm: np.ndarray) -> np.ndarray:
    out = np.empty_like(perm)
    out[perm] = np.arange(perm.shape[0])
    return out


def level_sets(a: sp.spmatrix) -> tuple[np.ndarray, np.ndarray]:
    """Dependency levels of the forward triangular solve on ``a``.

    ``level[i] = 1 + max(level[j] for j in strict lower row i)`` (0 for
    rows with an empty strict-lower part): the classical level-set
    schedule of SpTRSV.  Rows of equal level have no lower-triangular
    coupling, so they form legal parallel rounds — the minimal-round
    legal schedule for the pattern.  The *stored* strict-lower pattern is
    used (no ``eliminate_zeros``), matching what the substitution kernels
    and the ``repro.analysis.schedule`` race detector consider an edge.

    Returns ``(level, counts)``: level id per row (0-based) and rows per
    level.  Computed as a vectorized level-synchronous Kahn sweep: pop
    all rows with in-degree 0, decrement their out-neighbors' in-degrees
    with one ``bincount`` per level, repeat.
    """
    n = a.shape[0]
    low = sp.tril(sp.csr_matrix(a), k=-1, format="csr")
    indeg = np.diff(low.indptr)                  # strict-lower nnz per row
    out = sp.csr_matrix(low.T)                   # row j -> rows i that need j
    outdeg = np.diff(out.indptr)
    level = np.zeros(n, dtype=np.int64)
    frontier = np.flatnonzero(indeg == 0)
    lev = 0
    counts = []
    remaining = n
    # per-level work is O(edges out of the frontier), not O(n): the next
    # frontier is read off the rows whose in-degree was touched
    while frontier.size:
        level[frontier] = lev
        counts.append(frontier.size)
        remaining -= frontier.size
        cnt = outdeg[frontier]
        heads = out.indices[np.repeat(out.indptr[frontier], cnt)
                            + ragged_arange(cnt)]
        if heads.size:
            touched, dec = np.unique(heads, return_counts=True)
            indeg[touched] -= dec
            frontier = touched[indeg[touched] == 0]
        else:
            frontier = heads
        lev += 1
    if remaining:                                # cannot happen for tril
        raise ValueError("level_sets: dependency graph has a cycle")
    return level, np.asarray(counts, dtype=np.int64)


def ordering_digraph_edges(a: sp.spmatrix, perm_old_to_new: np.ndarray | None = None):
    """Directed edge set of the ordering graph under a permutation.

    Returns a set of (min_node, max_node, direction) triples keyed by the
    *original* node ids, where direction is +1 if the lower-original-id node
    precedes the other in the ordering.  Identical sets <=> equivalent
    orderings.
    """
    coo = sp.coo_matrix(symmetrize_pattern(a))
    n = a.shape[0]
    p = np.arange(n) if perm_old_to_new is None else np.asarray(perm_old_to_new)
    edges = set()
    for i, j in zip(coo.row, coo.col):
        if i >= j:
            continue
        edges.add((int(i), int(j), int(np.sign(p[j] - p[i]))))
    return edges
