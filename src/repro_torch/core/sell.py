# Copy of repro/core/sell.py (numpy/scipy only).  The port keeps its own copy
# because importing the reference package loads JAX; the two stay identical
# so setup products are bitwise-equal (tests/test_torch_setup.py).
"""SELL-w packing of the HBMC-ordered triangular factors (paper §4.4.2).

The paper stores L/U in sliced-ELL with slice size = w so each vectorized
round loads w contiguous rows.  On TPU we take the same idea one step
further: all rows belonging to one *global round* (color c, round l) are
mutually independent, so we pack them into one dense padded tile

    rows : (R,)      final row indices of the round     (pad -> n_slots-1)
    cols : (R, K)    column indices of off-diag entries (pad -> n_slots-1)
    vals : (R, K)    matching values                    (pad -> 0.0)
    dinv : (R,)      1 / diagonal                       (pad -> 0.0)

and stack the rounds:  S = n_c * b_s  sequential steps.  The substitution is
then a fixed-shape ``lax.fori_loop`` over S steps of fully dense gather/fma
work — the TPU analogue of "w-wide SIMD per round, one thread sync per color".

Padding scheme: index ``n_slots-1`` is a scratch slot whose value is always
read as garbage*0.0 (pad vals are zero) and written as 0.0 (pad dinv is
zero), so padded lanes are harmless.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .graph import ragged_arange
from .hbmc import HBMCOrdering


class PackingIndexError(ValueError):
    """A pack input carries an out-of-range index (corrupted CSR indices
    or a round referencing a nonexistent row).  Raised on the host before
    any buffer is written — a bad index that reached a packed table would
    otherwise surface only as a wrong answer or a device-side wrap."""


def _check_csr_indices(a: sp.csr_matrix, n_cols: int, what: str) -> None:
    idx = a.indices
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n_cols):
        bad = idx[(idx < 0) | (idx >= n_cols)][0]
        raise PackingIndexError(
            f"{what}: CSR column index {int(bad)} outside [0, {n_cols}) — "
            f"corrupted indices cannot be packed")


def _check_round_rows(rounds: list[np.ndarray], n: int, what: str) -> None:
    for s, r in enumerate(rounds):
        r = np.asarray(r)
        if r.size and (int(r.min()) < 0 or int(r.max()) >= n):
            bad = r[(r < 0) | (r >= n)][0]
            raise PackingIndexError(
                f"{what}: round {s} references row {int(bad)} outside "
                f"[0, {n})")


@dataclasses.dataclass
class StepTables:
    """Host-side packed tables; converted to jnp on first use."""
    rows: np.ndarray   # (S, R) int32
    cols: np.ndarray   # (S, R, K) int32
    vals: np.ndarray   # (S, R, K) f64
    dinv: np.ndarray   # (S, R) f64
    n_slots: int       # n_final + 1 (scratch slot at the end)
    # per-step live row count (R_s <= R), for occupancy accounting
    live: np.ndarray   # (S,) int32

    @property
    def shape(self):
        return self.rows.shape + (self.cols.shape[-1],)


def rounds_hbmc(ordering: HBMCOrdering, reverse: bool = False
                ) -> list[np.ndarray]:
    """Final row indices of every global round (c, l), in execution order."""
    b_s, w = ordering.block_size, ordering.w
    out = []
    colors = range(ordering.n_colors)
    for c in colors:
        base = int(ordering.color_start[c])
        nlev1 = int(ordering.lev1_per_color[c])
        k = np.arange(nlev1)[:, None]          # level-1 block within color
        j = np.arange(w)[None, :]              # lane
        for l in range(b_s):                   # round inside level-1 block
            rows = (base + k * (b_s * w) + l * w + j).ravel()
            out.append(rows)
    if reverse:
        out = out[::-1]
    return out


def rounds_bmc(bmc, reverse: bool = False) -> list[np.ndarray]:
    """Rounds for plain BMC: round (c, t) = t-th unknown of every block of
    color c.  Mathematically identical iteration to the sequential in-block
    sweep (blocks of one color are independent); this is what makes the BMC
    iteration-count comparison meaningful on the same machinery."""
    b_s = bmc.block_size
    color_start = np.concatenate([[0], np.cumsum(bmc.blocks_per_color * b_s)])
    out = []
    for c in range(bmc.n_colors):
        base = int(color_start[c])
        nb = int(bmc.blocks_per_color[c])
        k = np.arange(nb)
        for t in range(b_s):
            out.append(base + k * b_s + t)
    if reverse:
        out = out[::-1]
    return out


def rounds_mc(mc, reverse: bool = False) -> list[np.ndarray]:
    """Rounds for nodal multi-color ordering: one round per color."""
    start = np.concatenate([[0], np.cumsum(mc.color_counts)])
    out = [np.arange(start[c], start[c + 1]) for c in range(mc.n_colors)]
    if reverse:
        out = out[::-1]
    return out


def rounds_levelset(level: np.ndarray, counts: np.ndarray,
                    reverse: bool = False) -> list[np.ndarray]:
    """Rounds from a level-set schedule (``graph.level_sets``).

    Round ``l`` holds every row of dependency level ``l``, in ascending
    row order (the stable sort keeps the in-round lane order
    deterministic).  This is the minimal-round legal schedule for the
    pattern: row counts per round are whatever the dependency structure
    allows, unlike the fixed-width color rounds.  ``reverse=True``
    reverses the round *order* only (the backward-substitution
    convention shared by every ``rounds_*``).
    """
    order = np.argsort(level, kind="stable")
    out = np.split(order, np.cumsum(counts)[:-1]) if len(counts) else []
    if reverse:
        out = out[::-1]
    return out


def rounds_natural(n: int, reverse: bool = False) -> list[np.ndarray]:
    """Fully sequential rounds (the unordered baseline)."""
    out = [np.array([i]) for i in range(n)]
    if reverse:
        out = out[::-1]
    return out


def _pack_dtype(data: np.ndarray) -> np.dtype:
    """Host pack-buffer dtype: keep floating inputs (f32 stays f32);
    promote anything else (int test matrices) to f64."""
    dt = np.asarray(data).dtype
    return dt if np.issubdtype(dt, np.floating) else np.dtype(np.float64)


def pack_steps(tri: sp.csr_matrix, diag: np.ndarray,
               rounds: list[np.ndarray],
               drop_mask: np.ndarray | None = None,
               lane_multiple: int = 1) -> StepTables:
    """Pack a strictly-triangular matrix + diagonal into per-round tables.

    ``tri`` must be the strictly lower (forward) or strictly upper (backward)
    part in the target order; ``rounds`` the execution-ordered row sets
    (mutually independent within a round).  ``drop_mask`` (bool per row) drops
    rows (e.g. dummy padding) from the rounds.  ``lane_multiple`` rounds the
    lane axis R up to a multiple (pad lanes are the usual inert scratch-slot
    lanes) so the lane axis can be sharded evenly over a device mesh.
    """
    tri = sp.csr_matrix(tri)
    tri.sort_indices()
    n = tri.shape[0]
    _check_csr_indices(tri, n, "pack_steps")
    _check_round_rows(rounds, n, "pack_steps")
    n_slots = n + 1
    if drop_mask is not None:
        rounds = [r[~drop_mask[r]] for r in rounds]
        rounds = [r for r in rounds if len(r)]
    S = len(rounds)
    rlens = np.array([len(r) for r in rounds], dtype=np.int64)
    R = int(rlens.max(initial=0))
    R = -(-R // lane_multiple) * lane_multiple
    row_nnz = np.diff(tri.indptr)
    K = int(row_nnz.max(initial=0))
    K = max(K, 1)
    vdt = _pack_dtype(tri.data)
    # one flat scatter instead of a per-row Python loop: lane (s, t) holds
    # round s's t-th row; its nnz entries land at [(s*R + t)*K, ... + nnz)
    all_rows = np.concatenate(rounds).astype(np.int64)
    s_idx = np.repeat(np.arange(S), rlens)
    t_idx = ragged_arange(rlens)
    rows = np.full((S, R), n_slots - 1, dtype=np.int32)
    dinv = np.zeros((S, R), dtype=vdt)
    rows[s_idx, t_idx] = all_rows
    dinv[s_idx, t_idx] = 1.0 / diag[all_rows]
    counts = row_nnz[all_rows]
    k_off = ragged_arange(counts)
    src = np.repeat(tri.indptr[all_rows], counts) + k_off
    dst = np.repeat((s_idx * R + t_idx) * K, counts) + k_off
    cols = np.full(S * R * K, n_slots - 1, dtype=np.int32)
    vals = np.zeros(S * R * K, dtype=vdt)
    cols[dst] = tri.indices[src]
    vals[dst] = tri.data[src]
    return StepTables(rows=rows, cols=cols.reshape(S, R, K),
                      vals=vals.reshape(S, R, K), dinv=dinv,
                      n_slots=n_slots, live=rlens.astype(np.int32))


def pack_factor(l_final: sp.csr_matrix, fwd_rounds: list[np.ndarray],
                bwd_rounds: list[np.ndarray],
                drop_mask: np.ndarray | None = None,
                lane_multiple: int = 1
                ) -> tuple[StepTables, StepTables]:
    """Pack L (lower, incl. diagonal, target order) into forward and backward
    substitution tables (backward uses L^T, reverse round order)."""
    l_final = sp.csr_matrix(l_final)
    diag = l_final.diagonal()
    strict_lower = sp.tril(l_final, k=-1, format="csr")
    strict_upper = sp.csr_matrix(strict_lower.T)
    fwd = pack_steps(strict_lower, diag, fwd_rounds, drop_mask, lane_multiple)
    bwd = pack_steps(strict_upper, diag, bwd_rounds, drop_mask, lane_multiple)
    return fwd, bwd


def pack_factor_hbmc(l_final: sp.csr_matrix, ordering: HBMCOrdering
                     ) -> tuple[StepTables, StepTables]:
    return pack_factor(l_final,
                       rounds_hbmc(ordering, reverse=False),
                       rounds_hbmc(ordering, reverse=True),
                       drop_mask=ordering.is_dummy)


# ----------------------------------------------------------------------
# Round-major repacking (the Pallas kernel's layout contract).
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RoundMajorLayout:
    """The HBMC-index <-> round-major-position bijection (live lanes only).

    Round-major is the execution-order coordinate system: lane ``t`` of
    forward round ``s`` lives at position ``s * R + t`` of a dense ``(S*R,)``
    vector.  Pad lanes (``rows == n_slots - 1``) are *holes*: they hold exact
    zeros for the whole PCG loop and have no HBMC counterpart.

    This object is the ONLY place permutations live in the round-major-native
    solver path: ``embed`` maps the right-hand side in once per solve,
    ``extract`` maps the solution out once per solve.  Everything in between
    (SpMV, both triangular sweeps, all PCG state) stays in round-major
    coordinates.
    """
    rows: np.ndarray   # (S, R) int32 — HBMC index per position (pad -> n_slots-1)
    pos: np.ndarray    # (n_slots,) int64 — HBMC index -> position (none -> S*R)
    n_slots: int

    @property
    def n_steps(self) -> int:
        return self.rows.shape[0]

    @property
    def lanes(self) -> int:
        return self.rows.shape[1]

    @property
    def m(self) -> int:
        """Padded round-major dimension S*R."""
        return self.rows.size

    def embed(self, v: np.ndarray) -> np.ndarray:
        """HBMC-ordered (n,) or (n, B) -> round-major (m,) / (m, B), holes 0."""
        v = np.asarray(v)
        flat = self.rows.reshape(-1)
        live = flat != self.n_slots - 1
        out = np.zeros((self.m,) + v.shape[1:], dtype=v.dtype)
        out[live] = v[flat[live]]
        return out

    def extract(self, y: np.ndarray) -> np.ndarray:
        """Round-major (m,) or (m, B) -> HBMC-ordered (n,) / (n, B)."""
        y = np.asarray(y)
        flat = self.rows.reshape(-1)
        live = flat != self.n_slots - 1
        out = np.zeros((self.n_slots - 1,) + y.shape[1:], dtype=y.dtype)
        out[flat[live]] = y[live]
        return out


def round_major_layout(t: StepTables) -> RoundMajorLayout:
    """Layout induced by the forward StepTables (execution order)."""
    s_, r_ = t.rows.shape
    pos = np.full(t.n_slots, s_ * r_, dtype=np.int64)
    lane = np.arange(s_ * r_).reshape(s_, r_)
    live = t.rows != (t.n_slots - 1)
    pos[t.rows[live]] = lane[live]
    return RoundMajorLayout(rows=t.rows.astype(np.int32), pos=pos,
                            n_slots=t.n_slots)


@dataclasses.dataclass
class RoundMajorTables:
    """StepTables re-indexed into the dense *round-major* coordinate system.

    The Pallas kernel (kernels/hbmc_trisolve.py) stores the solution vector
    in execution order: lane ``t`` of round ``s`` lives at position
    ``s * R + t``.  That turns the per-round scatter of the XLA path
    (``y.at[rows].set``) into a dense contiguous VMEM store, which is the
    TPU analogue of the paper's Fig. 4.6 contiguous AVX-512 stores.

    ``cols`` here are *round-major positions* (entries of previous rounds),
    produced by composing the StepTables column indices with the
    HBMC-index -> round-major-position permutation.  ``rows`` keeps the
    inverse map (the HBMC index of every lane, pad lanes -> ``n_slots-1``)
    so solutions can be scattered back to HBMC order; it is the permutation
    referred to throughout as "kept so solutions map back".
    """
    cols: np.ndarray   # (S, R, K) int32 — round-major gather positions
    vals: np.ndarray   # (S, R, K) f64
    dinv: np.ndarray   # (S, R) f64
    rows: np.ndarray   # (S, R) int32 — HBMC index per lane (pad -> n_slots-1)
    n_slots: int

    @property
    def shape(self):
        return self.rows.shape + (self.cols.shape[-1],)


def to_round_major(t: StepTables) -> RoundMajorTables:
    """Convert scatter-by-``rows`` StepTables to the dense round-major layout.

    Column indices that point at unknowns never assigned to any lane (only
    the scratch pad slot, whose ``vals`` are zero) are mapped to ``S*R``;
    the kernel reads them via ``jnp.take(..., fill_value=0)`` so the
    out-of-range position contributes ``0 * 0``.
    """
    lay = round_major_layout(t)
    return RoundMajorTables(cols=lay.pos[t.cols].astype(np.int32),
                            vals=t.vals, dinv=t.dinv,
                            rows=lay.rows, n_slots=t.n_slots)


@dataclasses.dataclass
class FusedRoundMajorTables:
    """Forward AND backward sweeps packed for one fused 2S-step solve.

    The backward rounds are exactly the forward rounds reversed (``rounds_*``
    build them that way, lane order included), so in *forward* round-major
    coordinates the backward sweep's round ``s'`` writes the contiguous slice
    ``[(S-1-s')*R, (S-s')*R)`` — a dense store, same as the forward sweep.
    That makes one solution buffer sufficient: the forward half fills it with
    ``y = L^{-1} q`` slice by slice, the backward half overwrites it in place
    with ``z = L^{-T} y`` in reverse slice order.  Every value the backward
    gather touches is either already overwritten (a ``z`` entry from a later
    forward round — exactly its dependencies) or the current slice's ``y``
    read before the store.

    Step ``g`` of the fused schedule uses table row ``g``: rows ``0..S-1``
    are the forward rounds, rows ``S..2S-1`` the backward rounds in backward
    execution order.  ``cols`` of BOTH halves are forward round-major gather
    positions (missing -> ``m``, read via ``fill_value=0`` against zero
    ``vals``).
    """
    cols: np.ndarray   # (2S, R, K) int32 — fwd-round-major gather positions
    vals: np.ndarray   # (2S, R, K) f64
    dinv: np.ndarray   # (2S, R) f64
    layout: RoundMajorLayout

    @property
    def n_steps(self) -> int:
        """Rounds per sweep (the fused grid has 2 * n_steps steps)."""
        return self.layout.n_steps

    @property
    def shape(self):
        return self.cols.shape


def fuse_round_major(fwd: StepTables, bwd: StepTables) -> FusedRoundMajorTables:
    """Pack forward + backward StepTables into the fused round-major form."""
    if fwd.rows.shape != bwd.rows.shape or fwd.n_slots != bwd.n_slots:
        raise ValueError("forward/backward tables disagree on round shape")
    if not np.array_equal(bwd.rows[::-1], fwd.rows):
        raise ValueError("backward rounds must be the reversed forward "
                         "rounds (lane order included)")
    lay = round_major_layout(fwd)
    m = lay.m
    k = max(fwd.cols.shape[-1], bwd.cols.shape[-1])

    def half(t: StepTables) -> tuple[np.ndarray, np.ndarray]:
        s_, r_, kt = t.cols.shape
        cols = np.full((s_, r_, k), m, dtype=np.int32)
        vals = np.zeros((s_, r_, k), dtype=t.vals.dtype)
        cols[:, :, :kt] = lay.pos[t.cols]
        vals[:, :, :kt] = t.vals
        return cols, vals

    fc, fv = half(fwd)
    bc, bv = half(bwd)
    return FusedRoundMajorTables(
        cols=np.concatenate([fc, bc], axis=0),
        vals=np.concatenate([fv, bv], axis=0),
        dinv=np.concatenate([fwd.dinv, bwd.dinv], axis=0),
        layout=lay)


def permute_round_major(a: sp.spmatrix, layout: RoundMajorLayout
                        ) -> sp.csr_matrix:
    """Re-index a matrix from HBMC order into round-major positions (m x m).

    Rows/columns of unknowns without a round-major position (dummy padding,
    dropped from the rounds) are removed: their PCG state is identically
    zero in both layouts, so the Krylov process is unchanged.  Hole
    positions become empty rows, so SpMV writes exact zeros there and the
    round-major state vectors keep their holes at zero.
    """
    coo = sp.coo_matrix(a)
    m = layout.m
    rows = layout.pos[coo.row]
    cols = layout.pos[coo.col]
    live = (rows < m) & (cols < m)
    return sp.coo_matrix((coo.data[live], (rows[live], cols[live])),
                         shape=(m, m)).tocsr()


# ----------------------------------------------------------------------
# SELL-w packing of a full matrix for SpMV (paper's "sell_spmv" variant).
# ----------------------------------------------------------------------

@dataclasses.dataclass
class SellMatrix:
    """SELL-C-sigma with C = w, sigma = 1 (HBMC order is already the sort)."""
    cols: np.ndarray      # (n_slices, max_k, w) int32
    vals: np.ndarray      # (n_slices, max_k, w) f64
    slice_k: np.ndarray   # (n_slices,) live k per slice
    n: int
    w: int
    padded_nnz: int
    nnz: int


def _ell_scatter_indices(indptr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row, k) destination of every CSR nonzero, as one flat enumeration."""
    lens = np.diff(indptr)
    rows_of = np.repeat(np.arange(len(lens)), lens)
    return rows_of, ragged_arange(lens)


def pack_sell(a: sp.spmatrix, w: int) -> SellMatrix:
    a = sp.csr_matrix(a)
    a.sort_indices()
    n = a.shape[0]
    _check_csr_indices(a, a.shape[1], "pack_sell")
    n_pad = ((n + w - 1) // w) * w
    nnz_per_row = np.zeros(n_pad, dtype=np.int64)
    nnz_per_row[:n] = np.diff(a.indptr)
    n_slices = n_pad // w
    slice_k = nnz_per_row.reshape(n_slices, w).max(axis=1)
    max_k = int(max(slice_k.max(initial=0), 1))
    cols = np.zeros((n_slices, max_k, w), dtype=np.int32)
    vals = np.zeros((n_slices, max_k, w), dtype=_pack_dtype(a.data))
    rows_of, k_off = _ell_scatter_indices(a.indptr)
    cols[rows_of // w, k_off, rows_of % w] = a.indices
    vals[rows_of // w, k_off, rows_of % w] = a.data
    return SellMatrix(cols=cols, vals=vals,
                      slice_k=slice_k.astype(np.int32), n=n, w=w,
                      padded_nnz=int(np.sum(slice_k) * w), nnz=a.nnz)


def pack_ell(a: sp.spmatrix) -> tuple[np.ndarray, np.ndarray]:
    """Row-major ELL (the CRS-like gather path for SpMV): (cols, vals)."""
    a = sp.csr_matrix(a)
    a.sort_indices()
    n = a.shape[0]
    _check_csr_indices(a, a.shape[1], "pack_ell")
    k = int(np.diff(a.indptr).max(initial=0))
    k = max(k, 1)
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=_pack_dtype(a.data))
    rows_of, k_off = _ell_scatter_indices(a.indptr)
    cols[rows_of, k_off] = a.indices
    vals[rows_of, k_off] = a.data
    return cols, vals
