"""Irregular random-graph Laplacian plus a small diagonal (circuit-like).

A rewrite of ``repro_torch.core.matrices.graph_laplacian`` that takes its
generator from the run's seed: the same draws in the same order, and the
diagonal added as a sparse sum instead of ``setdiag``, so the matrix is
bitwise the port's for the same seed
(``portbench/tests/test_portbench_matrices.py``).

Parameters (the configuration's ``matrix`` object): ``n`` (nodes),
``avg_degree``.  Half the edges join a node to one of the next 15 (short
nets), half join two nodes drawn at random (long nets); weights are
U(0.1, 1); the diagonal is the negated row sum plus 1e-3.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def make(params: dict, rng: np.random.Generator) -> sp.csr_matrix:
    n, avg_degree = int(params["n"]), int(params["avg_degree"])
    m = n * avg_degree // 2
    i_short = rng.integers(0, n - 1, size=m // 2)
    j_short = np.minimum(i_short + rng.integers(1, 16, size=m // 2), n - 1)
    i_long = rng.integers(0, n, size=m - m // 2)
    j_long = rng.integers(0, n, size=m - m // 2)
    i = np.concatenate([i_short, i_long])
    j = np.concatenate([j_short, j_long])
    mask = i != j
    i, j = i[mask], j[mask]
    w = rng.uniform(0.1, 1.0, size=len(i))
    a = sp.coo_matrix((-w, (i, j)), shape=(n, n))
    a = (a + a.T).tocsr()
    a.sum_duplicates()
    d = -np.asarray(a.sum(axis=1)).ravel()
    return (a + sp.diags(d + 1e-3, format="csr")).tocsr()
