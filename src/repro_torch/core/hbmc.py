# Copy of repro/core/hbmc.py (numpy/scipy only).  The port keeps its own copy
# because importing the reference package loads JAX; the two stay identical
# so setup products are bitwise-equal (tests/test_torch_setup.py).
"""Hierarchical block multi-color ordering (paper §4).

HBMC = BMC + a secondary, *local* reordering inside level-1 blocks.

Level-1 block = ``w`` consecutive BMC blocks of one color (eq. 4.1); the
secondary reordering interleaves their unknowns: round l picks the l-th
unknown of each of the w member blocks (Fig. 4.3).  The resulting matrix has
``w x w`` *diagonal* level-2 diagonal blocks (eq. 4.7), so the forward /
backward substitution becomes ``b_s`` sequential steps of ``w`` independent
lanes per level-1 block (eq. 4.17-4.18) — the SIMD/vector axis.

Colors whose block count is not a multiple of ``w`` are padded with whole
dummy blocks (paper §4.3: "the assumption is satisfied using some dummy
unknowns").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .coloring import BMCOrdering, block_multicolor_ordering
from .graph import ragged_arange


def _validate_w(w, who: str) -> int:
    """Entry-point guard: ``w`` must be a positive int.

    ``w=0`` used to emit divide-by-zero RuntimeWarnings from the padded
    block-count arithmetic and then die with an opaque ``IndexError``
    deep in the secondary-permutation scatter.
    """
    if isinstance(w, bool) or not isinstance(w, (int, np.integer)):
        raise ValueError(
            f"{who}: w must be an int, got {type(w).__name__} ({w!r})")
    if w < 1:
        raise ValueError(
            f"{who}: w must be >= 1, got {w} "
            f"(w < 1 divides by zero in the level-1 aggregation)")
    return int(w)


@dataclasses.dataclass(frozen=True)
class HBMCOrdering:
    """Complete HBMC ordering over the padded system.

    ``perm`` maps *original* old indices -> final HBMC indices.
    ``secondary_perm`` maps BMC-padded indices -> final indices (this is the
    paper's pi, used in the equivalence tests).
    """
    perm: np.ndarray
    secondary_perm: np.ndarray
    n: int                       # original dimension
    n_final: int                 # padded dimension (multiple of b_s * w)
    block_size: int              # b_s
    w: int                       # SIMD width / lane count
    n_colors: int
    lev1_per_color: np.ndarray   # \bar n(c): level-1 blocks per color
    color_start: np.ndarray      # first final index of each color (len n_c+1)
    is_dummy: np.ndarray         # bool per final index
    bmc: BMCOrdering


def hbmc_ordering(a: sp.spmatrix, block_size: int, w: int) -> HBMCOrdering:
    w = _validate_w(w, "hbmc_ordering")   # fail before the block build
    bmc = block_multicolor_ordering(a, block_size)
    return hbmc_from_bmc(bmc, w)


def hbmc_from_bmc(bmc: BMCOrdering, w: int) -> HBMCOrdering:
    w = _validate_w(w, "hbmc_from_bmc")
    b_s = bmc.block_size
    n_colors = bmc.n_colors
    m = bmc.blocks_per_color                      # blocks per color (real)
    m_pad = ((m + w - 1) // w) * w                # padded to a multiple of w
    lev1 = m_pad // w                             # \bar n(c)
    color_sizes = m_pad * b_s
    color_start = np.concatenate([[0], np.cumsum(color_sizes)])
    n_final = int(color_start[-1])

    # --- secondary reordering: BMC-padded index -> final index -------------
    # BMC padded layout: color-major, block-major, in-block offset t.
    # Final layout: color-major, level-1-block-major, round l, lane j
    #   (k-th block of a color sits at lane j = k % w of level-1 block k // w;
    #    its t-th unknown lands in round l = t).
    # One segmented expression over all (color, block) pairs at once: the
    # per-block BMC/final bases are (total_blocks,) vectors, the in-block
    # offset t broadcasts along the second axis.
    bmc_color_start = np.concatenate(
        [[0], np.cumsum(bmc.blocks_per_color * b_s)])
    secondary = np.empty(bmc.n_padded, dtype=np.int64)
    color_of = np.repeat(np.arange(n_colors), m)   # per real block
    k = ragged_arange(m)                           # block index within color
    base_bmc = bmc_color_start[color_of] + k * b_s
    base_fin = color_start[color_of] + (k // w) * (b_s * w) + (k % w)
    t = np.arange(b_s)[None, :]                    # offset inside the block
    secondary[(base_bmc[:, None] + t).ravel()] = (
        base_fin[:, None] + t * w).ravel()

    perm = secondary[bmc.perm]          # old -> bmc-padded -> final

    is_dummy = np.ones(n_final, dtype=bool)
    is_dummy[perm] = False
    # unknowns that were dummies already at BMC padding stage remain dummy
    bmc_dummy_final = secondary[np.nonzero(bmc.is_dummy)[0]]
    is_dummy[bmc_dummy_final] = True

    return HBMCOrdering(
        perm=perm, secondary_perm=secondary, n=bmc.n, n_final=n_final,
        block_size=b_s, w=w, n_colors=n_colors,
        lev1_per_color=lev1.astype(np.int64), color_start=color_start,
        is_dummy=is_dummy, bmc=bmc)


def pad_system_hbmc(a: sp.spmatrix, b: np.ndarray | None, ordering: HBMCOrdering
                    ) -> tuple[sp.csr_matrix, np.ndarray | None]:
    """Apply the full HBMC permutation, embedding into the padded system."""
    npad = ordering.n_final
    coo = sp.coo_matrix(a)
    p = ordering.perm
    rows, cols = p[coo.row], p[coo.col]
    data = coo.data                # keep the caller's dtype (f32 stays f32)
    if not np.issubdtype(data.dtype, np.floating):
        data = data.astype(np.float64)
    dummy_idx = np.nonzero(ordering.is_dummy)[0]
    rows = np.concatenate([rows, dummy_idx])
    cols = np.concatenate([cols, dummy_idx])
    data = np.concatenate([data, np.ones(len(dummy_idx), dtype=data.dtype)])
    a_bar = sp.coo_matrix((data, (rows, cols)), shape=(npad, npad)).tocsr()
    b_bar = None
    if b is not None:
        b = np.asarray(b)          # keep the caller's dtype (f32 stays f32)
        if not np.issubdtype(b.dtype, np.floating):
            # same promotion rule as the matrix data: an int RHS must not
            # flow into the float solve un-promoted
            b = b.astype(np.float64)
        b_bar = np.zeros(npad, dtype=b.dtype)
        b_bar[p] = b
    return a_bar, b_bar


def verify_level2_structure(a_bar: sp.csr_matrix, ordering: HBMCOrdering) -> bool:
    """Check eq. (4.7): every w x w level-2 diagonal block of A_bar is diagonal.

    Equivalently: unknowns occupying the same round l of the same level-1
    block (a contiguous run of w final indices) are mutually independent.
    """
    w = ordering.w
    coo = sp.coo_matrix(a_bar)
    r, c = coo.row, coo.col
    mask = (r // w == c // w) & (r != c) & (coo.data != 0)
    return not bool(mask.any())
