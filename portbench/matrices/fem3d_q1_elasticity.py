"""3-D linear elasticity on trilinear (Q1) bricks, with a log-normal Young's
modulus a brick and one clamped face.

The mesh is an M x M x M grid of unit cubes on the (M + 1)^3 nodes (i, j, k),
i the x index and fastest; each node carries three displacements (u_x, u_y,
u_z), numbered node-major.  The nodes of the face z = 0 (k = 0) are clamped
and eliminated, so the unknowns are the M (M + 1)^2 nodes with k >= 1:
row 3 (i + (M + 1) (j + (M + 1) (k - 1))) + c for displacement c, and
n = 3 M (M + 1)^2.  A brick couples each of its 8 nodes to the other 7, so
a node inside the mesh couples to 27 nodes and its three rows hold 81
entries each; rows next to the clamped face, on the free faces, edges and
corners hold fewer.

The brick stiffness is that of isotropic linear elasticity (Poisson's ratio
``nu``) for Young's modulus 1, integrated by 2 x 2 x 2 Gauss quadrature
(exact for the trilinear brick); each brick's copy is scaled by its
modulus ``exp(N(0, sigma))``.  The assembly sums the 24 x 24 brick matrices
in COO form and converts to CSR: entries that cancel are kept as stored
zeros, as an assembly does (with ``sigma`` 0, one material, some 17% of
them cancel exactly; with ``sigma`` 1.0 none do).

Parameters (the configuration's ``matrix`` object): ``m`` (bricks a side),
``nu`` (Poisson's ratio), ``sigma`` (standard deviation of the log
modulus).  The moduli are drawn as one (M, M, M) array, x fastest in the
last axis: ``rng.normal(0, sigma, (M, M, M))`` indexed [k, j, i].
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

#: the brick's corners in local order, x fastest: corner a + 2 b + 4 c at
#: (a, b, c)
CORNERS = np.array([(a, b, c) for c in (0, 1) for b in (0, 1)
                    for a in (0, 1)], dtype=np.int64)


def elasticity_matrix(nu: float) -> np.ndarray:
    """6 x 6 isotropic stiffness for Young's modulus 1, Voigt order (xx,
    yy, zz, yz, xz, xy) with engineering shear strains."""
    lam = nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = 1.0 / (2.0 * (1.0 + nu))
    d = np.zeros((6, 6))
    d[:3, :3] = lam
    d[np.arange(3), np.arange(3)] += 2.0 * mu
    d[np.arange(3, 6), np.arange(3, 6)] = mu
    return d


def brick_stiffness(nu: float) -> np.ndarray:
    """24 x 24 stiffness of the unit Q1 brick for Young's modulus 1, dof
    3 corner + c: the integral of B^T D B over the cube by 2 x 2 x 2 Gauss
    quadrature (points (1 +- 1/sqrt(3)) / 2, weights 1/8)."""
    d = elasticity_matrix(nu)
    g = (0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0))
    k = np.zeros((24, 24))
    for z in g:
        for y in g:
            for x in g:
                p = np.array([x, y, z])
                # N_a = prod_d (corner_d ? p_d : 1 - p_d); dN_a / dp_e
                f = np.where(CORNERS == 1, p, 1.0 - p)       # (8, 3)
                s = np.where(CORNERS == 1, 1.0, -1.0)        # d f / d p
                grad = np.empty((8, 3))
                for e in range(3):
                    grad[:, e] = s[:, e] * np.prod(
                        np.delete(f, e, axis=1), axis=1)
                b = np.zeros((6, 24))
                for a in range(8):
                    gx, gy, gz = grad[a]
                    c = 3 * a
                    b[0, c], b[1, c + 1], b[2, c + 2] = gx, gy, gz
                    b[3, c + 1], b[3, c + 2] = gz, gy
                    b[4, c], b[4, c + 2] = gz, gx
                    b[5, c], b[5, c + 1] = gy, gx
                k += 0.125 * b.T @ d @ b
    return 0.5 * (k + k.T)


def modulus(m: int, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """Young's modulus of each brick, [k, j, i] over (M, M, M)."""
    return np.exp(rng.normal(0.0, sigma, size=(m, m, m)))


def assemble(m: int, nu: float, e: np.ndarray) -> sp.csr_matrix:
    """The stiffness matrix of the clamped mesh for brick moduli ``e``
    ([k, j, i]); stored zeros are kept."""
    p = m + 1
    k0 = brick_stiffness(nu)
    # the 8 corner nodes of each brick (brick order: i fastest)
    bi, bj, bk = np.meshgrid(np.arange(m), np.arange(m), np.arange(m),
                             indexing="ij")
    bi, bj, bk = (x.transpose(2, 1, 0).ravel() for x in (bi, bj, bk))
    nodes = ((bi[:, None] + CORNERS[None, :, 0])
             + p * ((bj[:, None] + CORNERS[None, :, 1])
                    + p * (bk[:, None] + CORNERS[None, :, 2])))   # (E, 8)
    # node -> unknown node (k >= 1), or -1 on the clamped face
    unknown = np.arange(p ** 3, dtype=np.int64) - p * p
    dofs = 3 * unknown[nodes][:, :, None] + np.arange(3)          # (E, 8, 3)
    dofs = np.where(unknown[nodes][:, :, None] < 0, -1, dofs)
    dofs = dofs.reshape(-1, 24)
    n = 3 * m * p * p
    rows = np.broadcast_to(dofs[:, :, None], (dofs.shape[0], 24, 24))
    cols = np.broadcast_to(dofs[:, None, :], (dofs.shape[0], 24, 24))
    # the upper triangle is summed, then mirrored, so that A is exactly
    # symmetric whatever order the duplicates are summed in
    keep = (rows >= 0) & (rows <= cols)
    vals = e.ravel()[:, None, None] * k0[None]
    idx = np.int32 if n < 2**31 else np.int64
    up = sp.coo_matrix((vals[keep], (rows[keep].astype(idx),
                                     cols[keep].astype(idx))),
                       shape=(n, n)).tocsr().tocoo()
    off = up.row != up.col
    a = sp.coo_matrix((np.concatenate([up.data, up.data[off]]),
                       (np.concatenate([up.row, up.col[off]]),
                        np.concatenate([up.col, up.row[off]]))),
                      shape=(n, n)).tocsr()
    a.sort_indices()
    return a


def make(params: dict, rng: np.random.Generator) -> sp.csr_matrix:
    m = int(params["m"])
    return assemble(m, float(params["nu"]),
                    modulus(m, float(params["sigma"]), rng))
