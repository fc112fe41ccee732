"""2-D P1 finite-element diffusion on equilateral triangles, with a
log-normal conductivity an element and Dirichlet boundary.

The mesh is the triangular lattice on an (nx + 2) x (ny + 2) node grid:
node (i, j) at i e1 + j e2 with e1 = (1, 0), e2 = (1/2, sqrt(3)/2), each
lattice cell cut into the triangles {(i, j), (i+1, j), (i, j+1)} and
{(i+1, j), (i+1, j+1), (i, j+1)}.  The outer ring of nodes holds u = 0 and
is eliminated; the unknowns are the nx x ny inner nodes, row (j - 1) nx +
(i - 1).  Each inner node couples to its six lattice neighbours, so a row
holds 7 entries, fewer on the boundary.

On an equilateral triangle of conductivity c the P1 stiffness is
c / (2 sqrt(3)) [[2, -1, -1], [-1, 2, -1], [-1, -1, 2]]: each edge takes
-c / (2 sqrt(3)) from each of its two triangles, and a node's diagonal is
the sum of its six edges' weights, those to the eliminated ring included.
No diagonal shift: the boundary alone makes the matrix definite, so the
conditioning grows with the grid as a diffusion operator's does.

Parameters (the configuration's ``matrix`` object): ``nx``, ``ny`` (inner
grid), ``sigma`` (standard deviation of the log conductivity).  The
conductivities are ``exp(N(0, sigma))``, drawn as one (2, ny + 1, nx + 1)
array (lower and upper triangle of each lattice cell).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_EDGE = 1.0 / (2.0 * np.sqrt(3.0))


def conductivity(nx: int, ny: int, sigma: float,
                 rng: np.random.Generator) -> np.ndarray:
    """c[0, J, I], c[1, J, I]: the lower and upper triangle of lattice cell
    (I, J), I in 0..nx, J in 0..ny."""
    return np.exp(rng.normal(0.0, sigma, size=(2, ny + 1, nx + 1)))


def assemble(nx: int, ny: int, c: np.ndarray) -> sp.csr_matrix:
    lo, up = c[0], c[1]
    # edge weights on the extended grid, indexed by the edge's first node
    # (I, J) in extended coordinates; each edge is in two triangles
    # (I, J)-(I+1, J): lower of cell (I, J), upper of cell (I, J-1)
    horiz = _EDGE * (lo[1:, :] + up[:-1, :])            # J 1..ny, I 0..nx
    # (I, J)-(I, J+1): lower of cell (I, J), upper of cell (I-1, J)
    vert = _EDGE * (lo[:, 1:] + up[:, :-1])             # J 0..ny, I 1..nx
    # (I+1, J)-(I, J+1): both triangles of cell (I, J)
    diag = _EDGE * (lo + up)                            # J 0..ny, I 0..nx

    n = nx * ny
    idx = np.arange(n).reshape(ny, nx)
    d = np.zeros((ny, nx))
    # each inner node (i, j) = extended (i+1, j+1): the six incident edges
    d += horiz[:, 1:] + horiz[:, :-1]                   # to east, to west
    d += vert[1:, :] + vert[:-1, :]                     # to north, to south
    d += diag[1:, :-1] + diag[:-1, 1:]                  # to NW, to SE

    rows, cols, vals = [idx.ravel()], [idx.ravel()], [d.ravel()]
    for src, dst, w in (
            (idx[:, :-1], idx[:, 1:], horiz[:, 1:-1]),      # east
            (idx[:-1, :], idx[1:, :], vert[1:-1, :]),       # north
            (idx[:-1, 1:], idx[1:, :-1], diag[1:-1, 1:-1])):  # north-west
        rows += [src.ravel(), dst.ravel()]
        cols += [dst.ravel(), src.ravel()]
        vals += [-w.ravel(), -w.ravel()]
    a = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    a.sort_indices()
    return a


def make(params: dict, rng: np.random.Generator) -> sp.csr_matrix:
    nx, ny = int(params["nx"]), int(params["ny"])
    return assemble(nx, ny, conductivity(nx, ny, float(params["sigma"]),
                                         rng))
