# Copy of repro/core/matrices.py (numpy/scipy only).  The port keeps its own copy
# because importing the reference package loads JAX; the two stay identical
# so setup products are bitwise-equal (tests/test_torch_setup.py).
"""Test-problem generators standing in for the paper's five datasets.

SuiteSparse is not available offline; each generator mimics the structure of
the corresponding paper matrix family (documented in DESIGN.md §6):

  Thermal2       -> 2-D 5-point FD Laplacian with smooth coefficient jumps
  Parabolic_fem  -> 2-D 5-point FD of (I - dt * Laplacian)  (implicit step)
  G3_circuit     -> irregular graph Laplacian + diagonal (circuit-like)
  Audikw_1       -> 3-D 27-point "structural" stencil (dense-ish rows)
  Ieej           -> 3-D 7-point edge-element-like curl-curl analogue,
                    semi-definite + shift handled by shifted IC (alpha=0.3)

All matrices are symmetric positive (semi-)definite.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplace_2d(nx: int, ny: int, coeff: np.ndarray | None = None
               ) -> sp.csr_matrix:
    """5-point FD Laplacian on an nx x ny grid (Dirichlet)."""
    n = nx * ny
    idx = np.arange(n).reshape(ny, nx)
    rows, cols, vals = [], [], []
    c = np.ones((ny, nx)) if coeff is None else coeff

    def add(i, j, v):
        rows.append(i); cols.append(j); vals.append(v)

    for dy, dx in ((0, 1), (1, 0)):
        src = idx[:ny - dy, :nx - dx].ravel()
        dst = idx[dy:, dx:].ravel()
        harm = 2.0 / (1.0 / c[:ny - dy, :nx - dx].ravel()
                      + 1.0 / c[dy:, dx:].ravel())
        rows.extend(src); cols.extend(dst); vals.extend(-harm)
        rows.extend(dst); cols.extend(src); vals.extend(-harm)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    d = -np.asarray(a.sum(axis=1)).ravel() + 1e-8
    a.setdiag(d + 4e-2)  # slight diagonal boost: SPD & Dirichlet-like
    return a.tocsr()


def laplace_3d(nx: int, ny: int, nz: int, stencil: int = 7) -> sp.csr_matrix:
    """7- or 27-point FD Laplacian on an nx x ny x nz grid."""
    n = nx * ny * nz
    idx = np.arange(n).reshape(nz, ny, nx)
    rows, cols = [], []
    if stencil == 7:
        offsets = [(0, 0, 1), (0, 1, 0), (1, 0, 0)]
    else:
        offsets = [(dz, dy, dx)
                   for dz in (0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                   if (dz, dy, dx) > (0, 0, 0)]
    for dz, dy, dx in offsets:
        zs = slice(max(0, -dz), nz - max(0, dz))
        ys = slice(max(0, -dy), ny - max(0, dy))
        xs = slice(max(0, -dx), nx - max(0, dx))
        zd = slice(max(0, dz), nz - max(0, -dz))
        yd = slice(max(0, dy), ny - max(0, -dy))
        xd = slice(max(0, dx), nx - max(0, -dx))
        src = idx[zs, ys, xs].ravel()
        dst = idx[zd, yd, xd].ravel()
        rows.extend(src); cols.extend(dst)
        rows.extend(dst); cols.extend(src)
    vals = -np.ones(len(rows))
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    d = -np.asarray(a.sum(axis=1)).ravel()
    a.setdiag(d + 1e-2)
    return a.tocsr()


def graph_laplacian(n: int, avg_degree: int = 4, seed: int = 0
                    ) -> sp.csr_matrix:
    """Irregular random-graph Laplacian + small diagonal (circuit-like)."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree // 2
    # mix of short-range and long-range edges (circuit nets)
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
    a.setdiag(d + 1e-3)
    return a.tocsr()


def curlcurl_like(nx: int, ny: int, nz: int, seed: int = 0) -> sp.csr_matrix:
    """Semi-definite curl-curl analogue: 7-point Laplacian with a rank-
    deficient-ish weighting + random reluctivity jumps (eddy-current-like)."""
    rng = np.random.default_rng(seed)
    a = laplace_3d(nx, ny, nz, stencil=7)
    n = a.shape[0]
    # heterogeneous material coefficient (iron vs air: 3 orders of magnitude)
    mat = np.where(rng.random(n) < 0.2, 1.0, 1e-3)
    dscale = sp.diags(np.sqrt(mat))
    a = (dscale @ a @ dscale).tocsr()
    # make it *semi*-definite-ish: shrink the diagonal boost
    a.setdiag(a.diagonal() - 0.9e-2 * mat)
    return a.tocsr()


def paper_problem(name: str, scale: str = "small") -> tuple[sp.csr_matrix, str]:
    """Return (A, description).  scale in {tiny, small, bench}."""
    dims = {
        "tiny":  dict(g2=24, g3=8,  n=600,    c3=8),
        "small": dict(g2=64, g3=16, n=4000,   c3=12),
        "bench": dict(g2=352, g3=46, n=120_000, c3=40),
    }[scale]
    if name == "thermal2":
        ny = nx = dims["g2"]
        rng = np.random.default_rng(1)
        coeff = np.exp(rng.normal(0, 1, size=(ny, nx)))
        return laplace_2d(nx, ny, coeff), "2-D heterogeneous thermal"
    if name == "parabolic_fem":
        nx = ny = dims["g2"]
        a = laplace_2d(nx, ny)
        n = a.shape[0]
        return (sp.identity(n, format="csr") + 0.25 * a).tocsr(), \
            "implicit parabolic step"
    if name == "g3_circuit":
        return graph_laplacian(dims["n"]), "irregular circuit-like"
    if name == "audikw_1":
        g = dims["g3"]
        return laplace_3d(g, g, g, stencil=27), "3-D 27-point structural"
    if name == "ieej":
        g = dims["c3"]
        return curlcurl_like(g, g, max(2, g // 2)), "eddy-current analogue"
    raise KeyError(name)


PAPER_PROBLEMS = ("thermal2", "parabolic_fem", "g3_circuit", "audikw_1", "ieej")
# paper §5.1: shifted ICCG with alpha = 0.3 for Ieej
PAPER_SHIFTS = {"ieej": 0.3}
