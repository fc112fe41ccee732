"""Static schedule race detector: prove a plan race-free before dispatch.

Port of ``repro.analysis.schedule``.  The dependency DAG of a triangular
factor L has an edge ``j -> i`` for every strictly-lower nonzero
``L[i, j]``: row ``i``'s substitution reads ``y[j]``, so ``j`` must be
*finished* first.  A round schedule is legal iff every edge crosses
strictly forward in round order: every round is an antichain of the DAG
(eq. 4.1), and every step reads only earlier-round writes.

The checkers verify that property at each level of materialization, and
give the reference's verdicts on the same inputs (their numpy code is the
reference's, line for line):

  ``check_rounds``         the ordering's round sets against the CSR
                           pattern (the O(nnz) "cheap" proof)
  ``check_step_tables``    the packed per-round gather tables
                           (``sell.StepTables``)
  ``check_fused_tables``   the fused fwd+bwd round-major tables
                           (``sell.FusedRoundMajorTables`` or the plan's
                           ``trisolve.DeviceFusedTables``)
  ``check_ic0_structure``  the IC(0) factorization step schedule

and one check the reference has no need of:

  ``check_segments``       a cut of a round-major table into barrier-free
                           segments (``kernels.segments``).  A Pallas TPU
                           grid runs its steps in order; on the card the
                           trisolve kernels launch once per segment and the
                           lanes of one launch run in no order against each
                           other.  A read of another lane's entry of a
                           slice written in the same launch races there
                           without an error, and the positional proof of
                           ``check_fused_tables`` accepts it (it reads
                           below its destination).  So every table a kernel
                           launches gets this check too.

All checkers return machine-readable :class:`Violation` witnesses (empty =
proven clean).  They take numpy arrays or torch tensors (a tensor is copied
to the host once, at entry).  ``validate_plan`` composes them for a built
``SolverPlan`` (the ``validate=`` knob of ``build_plan`` and of
``PlanCache`` admission), and ``python -m repro_torch.analysis`` runs them
from the command line.

Only numpy and scipy at import; torch and the rest of the port are imported
where a check needs them, so ``core.plan`` can defer-import this module.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import scipy.sparse as sp

#: Checkers stop collecting after this many witnesses per artifact: the
#: point of a witness is to pinpoint, not to enumerate every consequence of
#: one corrupted round.
MAX_VIOLATIONS = 16


@dataclasses.dataclass(frozen=True)
class Violation:
    """One schedule/contract defect, pinned to its witness.

    ``kind``   what property failed (e.g. ``"intra-round-edge"``)
    ``where``  which artifact it was found in (``"rounds"``,
               ``"step_tables"``, ``"fused_tables"``, ``"ic0_steps"``,
               ``"kernel"``, ...)
    ``round``  the offending round / step / grid index, when applicable
    ``rows``   the offending row pair ``(i, j)`` in the checked ordering
    ``edge``   the offending DAG edge ``(src, dst)`` (src must finish
               before dst may start) or table-position pair
    ``detail`` human-readable one-liner
    """
    kind: str
    where: str
    round: int | None = None
    rows: tuple | None = None
    edge: tuple | None = None
    detail: str = ""

    def __str__(self) -> str:
        bits = [f"{self.where}: {self.kind}"]
        if self.round is not None:
            bits.append(f"round={self.round}")
        if self.rows is not None:
            bits.append(f"rows={tuple(int(x) for x in self.rows)}")
        if self.edge is not None:
            bits.append(f"edge={tuple(int(x) for x in self.edge)}")
        if self.detail:
            bits.append(f"({self.detail})")
        return " ".join(bits)


class ScheduleError(ValueError):
    """A schedule failed static validation.  Carries the machine-readable
    ``violations`` list; the message shows the first few witnesses."""

    def __init__(self, violations: list[Violation], context: str = ""):
        self.violations = list(violations)
        head = "; ".join(str(v) for v in self.violations[:4])
        more = len(self.violations) - 4
        if more > 0:
            head += f"; ... {more} more"
        prefix = f"{context}: " if context else ""
        super().__init__(f"{prefix}schedule validation failed "
                         f"[{len(self.violations)} violation(s)]: {head}")


def _strict_lower_edges(a: sp.spmatrix) -> tuple[np.ndarray, np.ndarray]:
    """Dependency edges (src=j, dst=i) of the forward sweep: one per
    strictly-lower nonzero a[i, j]."""
    low = sp.tril(sp.csr_matrix(a), k=-1, format="coo")
    return low.col.astype(np.int64), low.row.astype(np.int64)


def check_rounds(a_bar: sp.spmatrix, rounds: list[np.ndarray],
                 drop_mask: np.ndarray | None = None,
                 where: str = "rounds") -> list[Violation]:
    """Prove ``rounds`` is a legal forward schedule for ``a_bar``.

    ``rounds`` are execution-ordered row sets of the (already ordered /
    padded) matrix; ``drop_mask`` marks rows excluded from the schedule
    (dummy padding).  O(nnz + n): one pass to build the row -> round map,
    one vectorized scan over the strictly-lower pattern.  This is exactly
    the ``validate="cheap"`` proof — forward-crossing edges imply both the
    antichain property and read-only-earlier-writes.
    """
    n = a_bar.shape[0]
    out: list[Violation] = []
    round_id = np.full(n, -1, dtype=np.int64)
    for s, r in enumerate(rounds):
        r = np.asarray(r)
        if len(r) and (r.min() < 0 or r.max() >= n):
            bad = int(r[(r < 0) | (r >= n)][0])
            out.append(Violation(
                kind="row-out-of-range", where=where, round=s,
                rows=(bad, bad),
                detail=f"round {s} schedules row {bad} outside [0, {n})"))
            if len(out) >= MAX_VIOLATIONS:
                return out
            r = r[(r >= 0) & (r < n)]
        uniq, counts = np.unique(r, return_counts=True)
        dup = np.concatenate([uniq[counts > 1], r[round_id[r] >= 0]])
        if len(dup):
            i = int(dup[0])
            prev = int(round_id[i]) if round_id[i] >= 0 else s
            out.append(Violation(
                kind="duplicate-row", where=where, round=s, rows=(i, i),
                detail=f"row {i} scheduled in rounds {prev} and {s}"))
            if len(out) >= MAX_VIOLATIONS:
                return out
        round_id[r] = s
    unsched = np.flatnonzero(round_id < 0)
    if drop_mask is not None:
        unsched = unsched[~drop_mask[unsched]]
    for i in unsched[:MAX_VIOLATIONS - len(out)]:
        out.append(Violation(
            kind="unscheduled-row", where=where, rows=(int(i), int(i)),
            detail=f"row {int(i)} appears in no round"))
    if len(out) >= MAX_VIOLATIONS:
        return out

    src, dst = _strict_lower_edges(a_bar)
    rs, rd = round_id[src], round_id[dst]
    live = (rs >= 0) & (rd >= 0)   # unscheduled endpoints already reported,
    # unless they were dropped rows — a dropped row carrying a dependency
    # edge is a silent read of a never-computed value:
    if drop_mask is not None:
        dropped_edge = np.flatnonzero(
            (~live) & (drop_mask[src] | drop_mask[dst]))
        for e in dropped_edge[:MAX_VIOLATIONS - len(out)]:
            out.append(Violation(
                kind="unscheduled-dependency", where=where,
                rows=(int(dst[e]), int(src[e])),
                edge=(int(src[e]), int(dst[e])),
                detail="dependency edge touches a row dropped from the "
                       "schedule"))
        if len(out) >= MAX_VIOLATIONS:
            return out
    bad_same = np.flatnonzero(live & (rs == rd))
    for e in bad_same[:MAX_VIOLATIONS - len(out)]:
        out.append(Violation(
            kind="intra-round-edge", where=where, round=int(rs[e]),
            rows=(int(dst[e]), int(src[e])),
            edge=(int(src[e]), int(dst[e])),
            detail=f"rows {int(src[e])} and {int(dst[e])} share round "
                   f"{int(rs[e])} but are connected — not an antichain"))
    if len(out) >= MAX_VIOLATIONS:
        return out
    bad_order = np.flatnonzero(live & (rs > rd))
    for e in bad_order[:MAX_VIOLATIONS - len(out)]:
        out.append(Violation(
            kind="cross-round-order", where=where, round=int(rd[e]),
            rows=(int(dst[e]), int(src[e])),
            edge=(int(src[e]), int(dst[e])),
            detail=f"row {int(dst[e])} (round {int(rd[e])}) reads row "
                   f"{int(src[e])} written later (round {int(rs[e])})"))
    return out


def check_reversed_rounds(fwd_rounds: list[np.ndarray],
                          bwd_rounds: list[np.ndarray],
                          where: str = "rounds") -> list[Violation]:
    """The backward schedule must be the reversed forward schedule (lane
    order included) — the property ``fuse_round_major`` builds on.  A legal
    forward schedule then implies a legal backward one (same DAG, reversed)."""
    if len(fwd_rounds) != len(bwd_rounds):
        return [Violation(
            kind="round-count-mismatch", where=where,
            detail=f"{len(fwd_rounds)} forward vs {len(bwd_rounds)} "
                   f"backward rounds")]
    out = []
    for s, (f, b) in enumerate(zip(fwd_rounds, reversed(bwd_rounds))):
        if not np.array_equal(np.asarray(f), np.asarray(b)):
            out.append(Violation(
                kind="backward-not-reversed", where=where, round=s,
                detail="backward rounds are not the reversed forward "
                       "rounds (lane order included)"))
            if len(out) >= MAX_VIOLATIONS:
                break
    return out


def _host(a) -> np.ndarray:
    """A numpy array of ``a``: a host array as it is, a torch tensor
    copied to the host (one copy per call)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _table_arrays(t) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(rows, cols, vals, n_slots) as host numpy from host or device tables."""
    return (_host(t.rows), _host(t.cols), _host(t.vals), int(t.n_slots))


def check_step_tables(tables, tri: sp.spmatrix | None = None,
                      where: str = "step_tables") -> list[Violation]:
    """Verify materialized per-round gather tables (``sell.StepTables``, or
    ``sweep_step_tables`` of a device sweep table) read only earlier-round
    writes.

    Checks, per step ``s``: every non-pad column index is a row assigned to
    a strictly earlier step (the packed form of the DAG proof), pad columns
    carry zero values, and indices stay in ``[0, n_slots)``.  With ``tri``
    (the strictly-triangular matrix the tables were packed from) it also
    proves **coverage**: every nonzero of ``tri`` whose row is scheduled
    appears in the tables — a silently dropped dependency is as much a race
    as a misordered one.
    """
    rows, cols, vals, n_slots = _table_arrays(tables)
    s_, r_ = rows.shape
    pad = n_slots - 1
    out: list[Violation] = []

    oob = (cols < 0) | (cols >= n_slots)
    if oob.any():
        s, t, k = (int(x) for x in np.argwhere(oob)[0])
        out.append(Violation(
            kind="index-out-of-range", where=where, round=s,
            detail=f"cols[{s},{t},{k}] = {int(cols[s, t, k])} outside "
                   f"[0, {n_slots})"))
    pad_val = (cols == pad) & (vals != 0)
    if pad_val.any():
        s, t, k = (int(x) for x in np.argwhere(pad_val)[0])
        out.append(Violation(
            kind="nonzero-pad-value", where=where, round=s,
            detail=f"vals[{s},{t},{k}] = {vals[s, t, k]!r} on the scratch "
                   f"pad slot"))

    step_of = np.full(n_slots, -1, dtype=np.int64)
    live = rows != pad
    uniq, counts = np.unique(rows[live], return_counts=True)
    for i in uniq[counts > 1][:MAX_VIOLATIONS - len(out)]:
        out.append(Violation(
            kind="duplicate-row", where=where, rows=(int(i), int(i)),
            detail=f"row {int(i)} assigned to multiple lanes"))
    step_idx = np.broadcast_to(np.arange(s_)[:, None], rows.shape)
    step_of[rows[live]] = step_idx[live]

    # every live (vals != 0, non-pad) gather must hit a row written earlier
    gather = (cols != pad) & (vals != 0)
    src_step = np.where(gather, step_of[np.minimum(cols, pad)], -2)
    reader_step = np.broadcast_to(np.arange(s_)[:, None, None], cols.shape)
    never = gather & (src_step == -1)
    late = gather & (src_step >= reader_step)
    for mask, kind, fmt in (
            (never, "unscheduled-dependency",
             "reads row {src} which is never written"),
            (late, "premature-read",
             "reads row {src} (step {ss}) at step {s}")):
        for s, t, k in np.argwhere(mask)[:MAX_VIOLATIONS - len(out)]:
            s, t, k = int(s), int(t), int(k)
            src = int(cols[s, t, k])
            dst = int(rows[s, t])
            out.append(Violation(
                kind=kind, where=where, round=s, rows=(dst, src),
                edge=(src, dst),
                detail=fmt.format(src=src, s=s,
                                  ss=int(step_of[src]))))
        if len(out) >= MAX_VIOLATIONS:
            return out

    if tri is not None:
        tri = sp.csr_matrix(tri)
        tri.sort_indices()
        packed = set(zip(rows[:, :, None].repeat(
            cols.shape[-1], axis=-1)[gather].tolist(),
            cols[gather].tolist()))
        coo = tri.tocoo()
        for i, j, v in zip(coo.row, coo.col, coo.data):
            if v == 0 or step_of[i] < 0:
                continue
            if (int(i), int(j)) not in packed:
                out.append(Violation(
                    kind="dropped-dependency", where=where,
                    rows=(int(i), int(j)), edge=(int(j), int(i)),
                    detail=f"pattern entry ({int(i)}, {int(j)}) missing "
                           f"from the packed tables"))
                if len(out) >= MAX_VIOLATIONS:
                    break
    return out


def check_fused_tables(fused, where: str = "fused_tables"
                       ) -> list[Violation]:
    """Verify fused fwd+bwd round-major tables
    (``sell.FusedRoundMajorTables`` or ``trisolve.DeviceFusedTables``) are
    triangular in execution order.

    In forward round-major coordinates, step ``g`` of the fused 2S-step
    schedule writes the contiguous destination slice ``d(g)*R`` with
    ``d(g) = g`` (forward half) or ``2S-1-g`` (backward half).  The race
    freedom proof is positional: every live gather of the forward half must
    read strictly BELOW its destination slice (already-written ``y``), every
    live gather of the backward half strictly ABOVE it (already-overwritten
    ``z`` — its dependencies), and pad gathers (``cols == m``) must carry
    zero values so the ``fill_value=0`` read is inert.
    """
    cols = _host(fused.cols)
    vals = _host(fused.vals)
    lay = getattr(fused, "layout", None)
    s2, r_, k_ = cols.shape
    s_ = s2 // 2
    m = s_ * r_
    out: list[Violation] = []
    if s2 != 2 * s_ or (lay is not None and lay.n_steps != s_):
        out.append(Violation(
            kind="shape-mismatch", where=where,
            detail=f"fused tables have {s2} steps, expected 2*S"))
        return out

    oob = (cols < 0) | (cols > m)
    if oob.any():
        g, t, k = (int(x) for x in np.argwhere(oob)[0])
        out.append(Violation(
            kind="index-out-of-range", where=where, round=g,
            detail=f"cols[{g},{t},{k}] = {int(cols[g, t, k])} outside "
                   f"[0, {m}]"))
    pad_val = (cols == m) & (vals != 0)
    if pad_val.any():
        g, t, k = (int(x) for x in np.argwhere(pad_val)[0])
        out.append(Violation(
            kind="nonzero-pad-value", where=where, round=g,
            detail=f"vals[{g},{t},{k}] = {vals[g, t, k]!r} on the "
                   f"out-of-range pad position"))

    pos = np.arange(m).reshape(s_, r_)
    dest = np.concatenate([pos, pos[::-1]])[:, :, None]
    live = (vals != 0) & (cols < m)
    fwd_bad = live[:s_] & (cols[:s_] >= dest[:s_])
    bwd_bad = live[s_:] & (cols[s_:] <= dest[s_:])
    for half, bad, goff, word in (("forward", fwd_bad, 0, "below"),
                                  ("backward", bwd_bad, s_, "above")):
        for g, t, k in np.argwhere(bad)[:MAX_VIOLATIONS - len(out)]:
            g, t, k = int(g), int(t), int(k)
            src = int(cols[goff + g, t, k])
            dst = int(dest[goff + g, t, 0])
            out.append(Violation(
                kind="premature-read", where=where, round=goff + g,
                rows=(dst, src), edge=(src, dst),
                detail=f"{half} half gathers position {src} at step "
                       f"{goff + g}, not strictly {word} its destination "
                       f"{dst}"))
        if len(out) >= MAX_VIOLATIONS:
            return out
    return out


def check_ic0_structure(st, where: str = "ic0_steps") -> list[Violation]:
    """Verify the IC(0) factorization step schedule is dependency-ordered.

    Step ``s`` of ``ic0.IC0Structure`` computes the entry positions
    ``steps[s][0]``; its inner-product operand positions (``pab``) and the
    diagonal of every dividing row (``dep_off``) must all be *computed at a
    strictly earlier step* — otherwise the vectorized batch reads an
    unfactored value.  Also proves every pattern position is computed
    exactly once.
    """
    out: list[Violation] = []
    nnz = int(st.indices.size)
    step_of_pos = np.full(nnz, -1, dtype=np.int64)
    for s, (pos, n_off, dep_off, rows_di, pab, npair, tgt) in \
            enumerate(st.steps):
        pos = np.asarray(pos)
        seen = step_of_pos[pos] >= 0
        for p in pos[seen][:MAX_VIOLATIONS - len(out)]:
            out.append(Violation(
                kind="duplicate-position", where=where, round=s,
                edge=(int(p), int(p)),
                detail=f"entry position {int(p)} computed at steps "
                       f"{int(step_of_pos[p])} and {s}"))
        step_of_pos[pos] = s
    if len(out) >= MAX_VIOLATIONS:
        return out
    missing = np.flatnonzero(step_of_pos < 0)
    for p in missing[:MAX_VIOLATIONS - len(out)]:
        out.append(Violation(
            kind="uncomputed-position", where=where, edge=(int(p), int(p)),
            detail=f"pattern position {int(p)} is never computed"))
    if len(out) >= MAX_VIOLATIONS:
        return out

    diag_pos = st.indptr[1:] - 1    # diagonal entry position of every row
    row_of_pos = np.repeat(np.arange(st.n), np.diff(st.indptr))
    for s, (pos, n_off, dep_off, rows_di, pab, npair, tgt) in \
            enumerate(st.steps):
        pos = np.asarray(pos)
        # off-diagonal entries divide by the diagonal of row dep_off
        if n_off:
            dstep = step_of_pos[diag_pos[np.asarray(dep_off)]]
            bad = np.flatnonzero(dstep >= s)
            for b in bad[:MAX_VIOLATIONS - len(out)]:
                j = int(np.asarray(dep_off)[b])
                i = int(row_of_pos[pos[b]])
                out.append(Violation(
                    kind="premature-read", where=where, round=s,
                    rows=(i, j), edge=(int(diag_pos[j]), int(pos[b])),
                    detail=f"step {s} divides by diag of row {j} computed "
                           f"at step {int(dstep[b])}"))
            if len(out) >= MAX_VIOLATIONS:
                return out
        if npair:
            pab = np.asarray(pab)
            ostep = step_of_pos[pab]
            bad = np.flatnonzero(ostep >= s)
            for b in bad[:MAX_VIOLATIONS - len(out)]:
                op = int(pab[b])
                tpos = int(pos[np.asarray(tgt)[b % npair]])
                out.append(Violation(
                    kind="premature-read", where=where, round=s,
                    rows=(int(row_of_pos[tpos]), int(row_of_pos[op])),
                    edge=(op, tpos),
                    detail=f"step {s} multiplies operand position {op} "
                           f"computed at step {int(ostep[b])}"))
            if len(out) >= MAX_VIOLATIONS:
                return out
    return out




def _tie_witness(cols: np.ndarray, g: int, slc: int,
                 m: int) -> tuple[int, int]:
    """(position, lane) of the first read at step ``g`` of another lane's
    entry of slice ``slc``, positions normalised as the kernels read them
    (``[-m, 0)`` wraps)."""
    r_ = cols.shape[1]
    c = cols[g].astype(np.int64)
    c = np.where(c < 0, c + m, c)
    lane = np.arange(r_, dtype=np.int64)[:, None]
    hit = (c >= 0) & (c < m) & (c // r_ == slc) & (c % r_ != lane)
    lane_, k = (int(x) for x in np.argwhere(hit)[0])
    return int(c[lane_, k]), lane_


def check_segments(cols, starts, fused: bool,
                   where: str = "segments") -> list[Violation]:
    """Prove that a cut of a round-major table into launches races nowhere
    on the card.

    ``cols`` is the (G, R, K) table a trisolve kernel launches (fused, G =
    2S, or one sweep, G = S), ``starts`` the ascending start steps of its
    segments, one launch each (the tables' ``.segments``).  A *tie* is a
    read at step g, lane l, of a position p of another lane (``p % R !=
    l``) in slice ``p // R``: every step that writes that slice must lie in
    another launch than g (``kernels.segments.segment_ties``).  So each tie
    (lo, hi] must hold a segment start.  Any cut that does is legal; the
    greedy starts of ``barrier_segments`` are one, one launch per step
    (``np.arange(G)``) another.

    Witnesses: ``"intra-step-read"`` for a step that reads another lane's
    entry of the slice it writes (no cut orders it; ``round`` the step);
    ``"segment-form"`` for starts that are not ascending from 0 below G;
    ``"segment-race"`` for a tie inside one segment, with ``round`` the
    reading step, ``rows`` (reading step, writing step) and ``edge``
    (position, lane) of the read.
    """
    from ..kernels.segments import segment_ties, step_dest
    cols = _host(cols)
    reader, writer = segment_ties(cols, fused)
    order = np.lexsort((writer, reader))
    reader, writer = reader[order], writer[order]
    n_steps, r_ = cols.shape[:2]
    m = (n_steps // 2 if fused else n_steps) * r_
    dest = step_dest(n_steps, fused)
    out: list[Violation] = []
    for i in np.flatnonzero(reader == writer)[:MAX_VIOLATIONS]:
        g = int(reader[i])
        p, lane = _tie_witness(cols, g, int(dest[g]), m)
        out.append(Violation(
            kind="intra-step-read", where=where, round=g, rows=(g, g),
            edge=(p, lane),
            detail=f"step {g} lane {lane} reads position {p}, another "
                   f"lane's entry of the slice the step writes; no launch "
                   f"boundary can order that"))
    if out:
        return out
    starts = np.asarray(starts, dtype=np.int64).ravel()
    if (starts.size == 0 or starts[0] != 0 or np.any(np.diff(starts) <= 0)
            or starts[-1] >= max(n_steps, 1)):
        return [Violation(
            kind="segment-form", where=where,
            detail=f"segments must be ascending step starts from 0 below "
                   f"{n_steps}, got {starts.tolist()}")]
    lo, hi = np.minimum(reader, writer), np.maximum(reader, writer)
    # the tie is ordered iff the last start at or before hi lies after lo
    at = np.searchsorted(starts, hi, side="right") - 1
    for i in np.flatnonzero(starts[at] <= lo)[:MAX_VIOLATIONS]:
        g, w = int(reader[i]), int(writer[i])
        p, lane = _tie_witness(cols, g, int(dest[w]), m)
        s0 = int(starts[at[i]])
        s1 = int(starts[at[i] + 1]) if at[i] + 1 < starts.size else n_steps
        out.append(Violation(
            kind="segment-race", where=where, round=g, rows=(g, w),
            edge=(p, lane),
            detail=f"step {g} lane {lane} reads position {p} of slice "
                   f"{p // r_}, which step {w} writes in the same launch "
                   f"(segment [{s0}, {s1})): they race on the card"))
    return out


def sweep_step_tables(t, cols: np.ndarray | None = None):
    """The ``sell.StepTables`` a device sweep table runs, for
    ``check_step_tables``.

    ``t`` is a ``kernels.ops.DeviceRoundMajorTables`` (the index layout
    keeps no host ``StepTables``): ``cols`` (its host copy, if the caller
    has one) holds round-major positions, ``t.rows`` the HBMC row of each
    lane (``n + j`` for the j-th pad lane).  Each position maps back to the
    row of its lane and the hole to the scratch slot ``n``.  A table made
    by ``sell.to_round_major`` maps back to the StepTables it was made from,
    except that a column of a row without a lane (a read of a dropped row)
    comes back as the scratch slot: its live value is then witnessed as a
    ``nonzero-pad-value`` rather than an ``unscheduled-dependency``.
    """
    n = int(t.n_slots) - 1
    lane_rows = _host(t.rows)
    lane_rows = np.where(lane_rows < n, lane_rows, n)
    c = _host(t.cols) if cols is None else cols
    m = lane_rows.size
    inside = (c >= 0) & (c < m)
    rows_of_cols = np.where(inside, lane_rows[np.where(inside, c, 0)], n)
    return types.SimpleNamespace(
        rows=lane_rows.reshape(tuple(t.dinv.shape)), cols=rows_of_cols,
        vals=_host(t.vals), n_slots=int(t.n_slots))


def check_shard_block(whole, block, mesh, axis: str,
                      where: str = "shard") -> list[Violation]:
    """The lane block a mesh rank keeps (``block``) must be its slice of the
    whole fused tables (``whole``): lanes ``[rank * r_loc, (rank + 1) *
    r_loc)`` of every step, as ``trisolve.shard_fused_tables`` cuts them."""
    import torch

    from ..core.mesh import axis_group
    _, size, rank = axis_group(mesh, axis)
    r_loc = whole.lanes // size
    lanes = slice(rank * r_loc, (rank + 1) * r_loc)
    for name in ("cols", "vals", "dinv"):
        kept, want = getattr(block, name), getattr(whole, name)[:, lanes]
        if not torch.equal(kept, want):
            return [Violation(
                kind="shard-mismatch", where=where, round=rank,
                detail=f"rank {rank} of {size} keeps {name} "
                       f"{tuple(kept.shape)} that is not lanes "
                       f"[{lanes.start}, {lanes.stop}) of the whole tables "
                       f"{tuple(getattr(whole, name).shape)}")]
    return []


# ---------------------------------------------------------------------------
# Plan-level composition (the validate= knob).
# ---------------------------------------------------------------------------

VALIDATE_MODES = ("off", "cheap", "full", "deep")


def check_validate_mode(mode: str) -> None:
    """Raise ``ValueError`` naming ``validate`` for an unknown mode."""
    if mode not in VALIDATE_MODES:
        raise ValueError(f"unknown validate mode {mode!r}; expected one of "
                         f"{VALIDATE_MODES}")


def _segment_check(t, cols: np.ndarray, fused: bool,
                   where: str) -> list[Violation]:
    """``check_segments`` of the segments a device table launches with,
    computed here from the same host copy of ``cols`` when the table has
    none yet (they are kept, so the first apply does not copy ``cols``
    again)."""
    from ..kernels.segments import barrier_segments
    if "segments" not in vars(t):
        try:
            t.segments = barrier_segments(cols, fused)
        except ScheduleError as err:
            return [dataclasses.replace(v, where=where)
                    for v in err.violations]
    return check_segments(cols, t.segments, fused, where=where)


def _gather_whole_tables(plan):
    """The whole fused tables of a built mesh plan, which keeps only its
    lane block: every rank's block all-gathered over the mesh axis (SPMD:
    every rank validates, as every rank builds).  Raises ``ValueError``
    when the gather cannot run."""
    import torch.distributed as dist

    from ..core.mesh import gather_lanes
    from ..core.trisolve import DeviceFusedTables
    if not dist.is_initialized():
        raise ValueError(
            "a mesh plan keeps only its lane block of the fused tables, and "
            "its process group is gone: the whole tables cannot be gathered "
            "to validate it; validate while the group lives, or build it "
            "with validate=")
    t = plan._precond.tables
    return DeviceFusedTables(
        *(gather_lanes(getattr(t, name), plan.mesh, plan.mesh_axis)
          for name in ("cols", "vals", "dinv")))


def _check_tables(plan, tables: dict | None) -> list[Violation]:
    """The tables the plan's kernels launch: the fused table and its
    segments (round-major), each sweep's step tables and segments (index),
    or the whole fused table, its segments and the rank's block of it
    (mesh: the build's whole tables, else the ranks' blocks gathered)."""
    if plan.mesh is not None:
        whole = (tables or {}).get("fused")
        if whole is None:
            whole = _gather_whole_tables(plan)
        cols = _host(whole.cols)
        out = check_fused_tables(types.SimpleNamespace(
            cols=cols, vals=_host(whole.vals)))
        out += _segment_check(whole, cols, True, "segments/fused")
        return out + check_shard_block(whole, plan._precond.tables,
                                       plan.mesh, plan.mesh_axis)
    if plan.layout == "round_major":
        t = plan._precond.tables
        cols = _host(t.cols)
        out = check_fused_tables(types.SimpleNamespace(cols=cols,
                                                       vals=_host(t.vals)))
        return out + _segment_check(t, cols, True, "segments/fused")
    out: list[Violation] = []
    kernel = plan._precond.kernel
    for name, t in (("fwd", kernel.fwd), ("bwd", kernel.bwd)):
        cols = _host(t.cols)
        steps = (tables or {}).get(name)
        out += check_step_tables(
            steps if steps is not None else sweep_step_tables(t, cols),
            where=f"step_tables/{name}")
        out += _segment_check(t, cols, False, f"segments/{name}")
    return out


def validate_plan(plan, mode: str = "full",
                  tables: dict | None = None) -> list[Violation]:
    """Run the race detector against a built ``SolverPlan``.

    ``mode="cheap"``: the O(nnz) round-monotonicity scan of the ordering's
    rounds against the ordered matrix pattern, plus the
    backward-is-reversed-forward check.  ``mode="full"``: additionally the
    *materialized* schedules: the tables the plan's kernels launch
    (``check_fused_tables`` on the fused table, or ``check_step_tables``
    on each sweep of the index layout), ``check_segments`` on every cut
    the trisolve kernels launch with, and the IC(0) factorization step
    schedule.  ``mode="deep"``: on top of "full", the kernel checks
    (``kernel_checks.check_plan_kernels``) and the dtype-flow lint of every
    path (``dtype_flow.check_plan_dtype_flow``).  Returns the violation
    list (empty = proven); raise via :func:`assert_plan_valid`.

    ``tables`` are what ``SolverPlan``'s build still holds when it
    validates: ``{"fwd", "bwd"}`` host ``StepTables`` of an index plan
    (else they are read back from the device sweep tables,
    ``sweep_step_tables``) and ``{"fused"}``, the whole fused tables of a
    mesh plan before they were sharded.  A built mesh plan keeps only its
    lane block: "full" then all-gathers the ranks' blocks over the mesh
    axis (every rank must call it, as every rank builds), and raises
    ``ValueError`` when the process group is gone.  A plan made by
    ``SolverPlan.from_arrays`` has no setup state and raises
    ``ValueError``, as its ``refactor`` does.
    """
    check_validate_mode(mode)
    if mode == "off":
        return []
    sysd = plan._sysd
    if sysd is None:
        raise ValueError("a plan made by from_arrays has no setup state to "
                         "validate; build it with build_plan")
    out = check_rounds(sysd.a_bar, sysd.fwd_rounds, drop_mask=sysd.drop)
    out += check_reversed_rounds(sysd.fwd_rounds, sysd.bwd_rounds)
    if mode == "cheap" or out:
        return out
    out += _check_tables(plan, tables)
    out += check_ic0_structure(plan._structure)
    if mode == "deep" and not out:
        from .dtype_flow import check_plan_dtype_flow
        from .kernel_checks import check_plan_kernels
        out += check_plan_kernels(plan)
        out += check_plan_dtype_flow(plan)
    return out


def assert_plan_valid(plan, mode: str = "full", context: str = "",
                      tables: dict | None = None) -> None:
    """``validate_plan`` that raises :class:`ScheduleError` on violations."""
    violations = validate_plan(plan, mode, tables=tables)
    if violations:
        raise ScheduleError(violations, context=context)
