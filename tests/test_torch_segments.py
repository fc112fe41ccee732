"""Barrier-free segments of the round-major step tables
(``repro_torch.kernels.segments``), which the trisolve kernels (B1 and B5
for one RHS, B3 and B6 batched) launch by: one CUDA launch per segment
instead of one per step.

The card runs the steps of one segment with one thread per (lane, column),
the same lane at every step, and the threads in no order.  A numpy
emulator here runs each segment lane by lane, in ascending and in
descending lane order -- two of the orders the card may take -- and must
give the plain step-major version's bits; with the segments merged it must
not, which shows that it catches a missing barrier.  The kernels themselves
are held to the same bits on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core import (PAPER_PROBLEMS, PAPER_SHIFTS, SolverPlan,
                              build_plan, paper_problem, trisolve)
from repro_torch.core.matrices import laplace_2d
from repro_torch.kernels import (hbmc_trisolve, hbmc_trisolve_batched,
                                 hbmc_trisolve_batched_ref,
                                 hbmc_trisolve_fused,
                                 hbmc_trisolve_fused_batched,
                                 hbmc_trisolve_fused_batched_ref,
                                 hbmc_trisolve_fused_ref, hbmc_trisolve_ref)
from repro_torch.kernels import ops, segments
from repro_torch.kernels.segments import barrier_segments, step_dest

KNOBS = dict(block_size=16, w=8, device="cpu")
# (fused, forward sweep, backward sweep) segment counts of the tiny paper
# plans at block 16, w 8, and the starts themselves where they are few
COUNTS = {
    "coloring": {"thermal2": (5, 3, 3), "parabolic_fem": (5, 3, 3),
                 "g3_circuit": (27, 14, 14), "audikw_1": (7, 4, 4),
                 "ieej": (3, 2, 2)},
    "levelset": {"thermal2": (49, 25, 25), "parabolic_fem": (49, 25, 25),
                 "g3_circuit": (55, 28, 28), "audikw_1": (39, 20, 20),
                 "ieej": (21, 11, 11)},
}
STARTS = {
    ("coloring", "thermal2"): ([0, 17, 40, 71, 88], [0, 17, 40],
                               [0, 23, 40]),
    ("coloring", "audikw_1"): ([0, 24, 32, 56, 88, 96, 120],
                               [0, 24, 32, 56], [0, 24, 32, 56]),
    ("coloring", "ieej"): ([0, 16, 48], [0, 16], [0, 16]),
}


def _thermal2(grid):
    coeff = np.exp(np.random.default_rng(1).normal(0, 1, size=(grid, grid)))
    return laplace_2d(grid, grid, coeff)


def _plans(name, scheduler="coloring"):
    a, _ = paper_problem(name, scale="tiny")
    kw = dict(KNOBS, shift=PAPER_SHIFTS.get(name, 0.0), scheduler=scheduler)
    return build_plan(a, **kw), build_plan(a, layout="index", **kw)


def _tables(name, scheduler="coloring"):
    """(label, cols, vals, dinv, fused) of a tiny paper plan's fused table
    and of both sweeps of its index plan, as numpy."""
    plan, plan_idx = _plans(name, scheduler)
    t, kp = plan._precond.tables, plan_idx._precond.kernel
    return [(lab, x.cols.numpy(), x.vals.numpy(), x.dinv.numpy(), fused)
            for lab, x, fused in (("fused", t, True), ("fwd", kp.fwd, False),
                                  ("bwd", kp.bwd, False))]


def emulate(cols, vals, dinv, q, starts, fused, descending=False,
            mask=True):
    """Each segment lane by lane, each lane's steps in order, one column at
    a time in Python floats, with the kernels' arithmetic: the gather
    masked as ``jnp.take(fill_value=0)``, products rounded and summed k in
    order from 0, then ``(q_cur - acc) * dinv``.  q: (S, R, B) -> (S*R, B).

    The state starts as NaN, standing for the kernels' uninitialised
    buffer; as in the kernels, a forward step g reads 0 from the slices at
    or after g, which no earlier step wrote (``mask=False`` reads them).
    """
    n_steps, r_, k_ = cols.shape
    s_ = q.shape[0]
    m = s_ * r_
    c = cols.astype(np.int64)
    c = np.where(c < 0, c + m, c)
    valid = (c >= 0) & (c < m)
    c, valid = c.tolist(), valid.tolist()
    vals, dinv = vals.tolist(), dinv.tolist()
    dest = step_dest(n_steps, fused).tolist()
    bounds = list(starts) + [n_steps]
    lanes = range(r_ - 1, -1, -1) if descending else range(r_)
    out = np.empty((m, q.shape[2]))
    for col in range(q.shape[2]):
        qb = q[..., col].tolist()
        y = [float("nan")] * m
        for g0, g1 in zip(bounds[:-1], bounds[1:]):
            for lane in lanes:
                for g in range(g0, g1):
                    cg, vg, ok = c[g][lane], vals[g][lane], valid[g][lane]
                    lim = g * r_ if mask and (not fused or g < s_) else m
                    acc = 0.0
                    for j in range(k_):
                        acc = acc + vg[j] * (y[cg[j]] if ok[j] and
                                             cg[j] < lim else 0.0)
                    p = dest[g] * r_ + lane
                    q_cur = qb[g][lane] if (not fused or g < s_) else y[p]
                    y[p] = (q_cur - acc) * dinv[g][lane]
        out[:, col] = y
    return out


def _plain(cols, vals, dinv, q, fused):
    ref = (hbmc_trisolve_fused_batched_ref if fused
           else hbmc_trisolve_batched_ref)
    return ref(*(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (cols, vals, dinv, q))).numpy()


def _rhs(cols, fused, nb, seed):
    n_steps, r_, _ = cols.shape
    s_ = n_steps // 2 if fused else n_steps
    return np.random.default_rng(seed).normal(size=(s_, r_, nb))


def test_thermal2_segments_have_the_1m_plans_structure():
    """thermal2 at grid 256 (n = 65,536) has the 1M plan's structure at
    block 16, w 8: 2 colors, S = 32; one segment per color boundary."""
    a = _thermal2(256)
    plan = build_plan(a, **KNOBS)
    plan_idx = build_plan(a, layout="index", **KNOBS)
    t, kp = plan._precond.tables, plan_idx._precond.kernel
    assert tuple(t.cols.shape) == (64, 2048, 4)
    assert barrier_segments(t.cols.numpy(), fused=True).tolist() == \
        [0, 16, 48]
    for sweep in (kp.fwd, kp.bwd):
        assert tuple(sweep.cols.shape) == (32, 2048, 4)
        assert barrier_segments(sweep.cols.numpy(), fused=False).tolist() \
            == [0, 16]


@pytest.mark.parametrize("scheduler", ["coloring", "levelset"])
@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_segments_pinned_on_paper_plans(name, scheduler):
    """Under ``levelset`` nearly every step is its own segment (tiny
    thermal2: 49 for 50 fused steps): its rounds are dependency levels, so
    a lane's rows of one round depend on other lanes' rows of the round
    before."""
    got = []
    for _, cols, _, _, fused in _tables(name, scheduler):
        seg = barrier_segments(cols, fused)
        assert seg.dtype == np.int32 and seg[0] == 0
        assert np.all(np.diff(seg) > 0) and seg[-1] < cols.shape[0]
        got.append(seg.tolist())
    assert tuple(len(s) for s in got) == COUNTS[scheduler][name]
    if (scheduler, name) in STARTS:
        assert tuple(got) == STARTS[scheduler, name]


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_lane_order_emulation_is_bitwise_step_major(name, nb):
    """Fused and sweep tables, lanes ascending and descending within each
    segment: bitwise the plain step-major version."""
    for i, (lab, cols, vals, dinv, fused) in enumerate(_tables(name)):
        q = _rhs(cols, fused, nb, seed=10 * nb + i)
        want = _plain(cols, vals, dinv, q, fused)
        seg = barrier_segments(cols, fused)
        for descending in (False, True):
            got = emulate(cols, vals, dinv, q, seg, fused, descending)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {lab} "
                                          f"descending={descending}")


def test_levelset_emulation_is_bitwise_step_major():
    for lab, cols, vals, dinv, fused in _tables("thermal2", "levelset"):
        q = _rhs(cols, fused, 2, seed=5)
        want = _plain(cols, vals, dinv, q, fused)
        for descending in (False, True):
            np.testing.assert_array_equal(
                emulate(cols, vals, dinv, q, barrier_segments(cols, fused),
                        fused, descending), want, err_msg=lab)


@pytest.mark.parametrize("name", ["thermal2", "ieej"])
def test_merged_segments_are_caught_by_the_emulator(name):
    """One segment for the whole table (no barrier at all) races: on every
    table one of the emulator's lane orders, at least, gives other bits
    (the ascending one on the fused tables)."""
    for lab, cols, vals, dinv, fused in _tables(name):
        q = _rhs(cols, fused, 1, seed=3)
        want = _plain(cols, vals, dinv, q, fused)
        differ = [not np.array_equal(
            emulate(cols, vals, dinv, q, [0], fused, d), want)
            for d in (False, True)]
        assert any(differ), (name, lab)
        assert differ[0] or not fused, (name, lab)


def test_dropping_any_start_races():
    """Every computed start is needed: without any one of them the
    emulator leaves the step-major bits, in one lane order or the other."""
    _, cols, vals, dinv, fused = _tables("ieej")[0]
    q = _rhs(cols, fused, 1, seed=4)
    want = _plain(cols, vals, dinv, q, fused)
    seg = barrier_segments(cols, fused).tolist()
    for drop in seg[1:]:
        fewer = [s for s in seg if s != drop]
        assert any(not np.array_equal(
            emulate(cols, vals, dinv, q, fewer, fused, d), want)
            for d in (False, True)), drop


def _random_fused(s, r, k, seed):
    """Random fused tables whose steps read any other slice (and the hole):
    many cross-lane ties, so many segments."""
    rng = np.random.default_rng(seed)
    m = s * r
    dest = step_dest(2 * s, True)
    cols = rng.integers(-m, m + 3, size=(2 * s, r, k))
    own = (np.where(cols < 0, cols + m, cols) // r) == dest[:, None, None]
    cols = np.where(own, m, cols).astype(np.int32)
    vals = 0.3 * rng.normal(size=(2 * s, r, k))
    dinv = rng.uniform(0.5, 1.5, size=(2 * s, r))
    return cols, vals, dinv


@pytest.mark.parametrize("seed", range(4))
def test_random_tables_emulate_bitwise(seed):
    cols, vals, dinv = _random_fused(4, 6, 2, seed)
    q = _rhs(cols, True, 2, seed)
    want = _plain(cols, vals, dinv, q, True)
    seg = barrier_segments(cols, True)
    assert 1 < seg.size <= cols.shape[0]
    for descending in (False, True):
        np.testing.assert_array_equal(
            emulate(cols, vals, dinv, q, seg, True, descending), want)
    # one launch per step is always a valid cut
    np.testing.assert_array_equal(
        emulate(cols, vals, dinv, q, np.arange(cols.shape[0]), True), want)


def test_own_lane_reads_never_cut_a_segment():
    """A table whose every read is of the reading lane's own entries (or
    the hole) is one segment, however its steps chain."""
    s, r, k = 5, 7, 3
    m = s * r
    rng = np.random.default_rng(0)
    slices = rng.integers(0, s, size=(2 * s, r, k))
    cols = (slices * r + np.arange(r)[None, :, None]).astype(np.int32)
    cols[:, :, 0] = m
    assert barrier_segments(cols, fused=True).tolist() == [0]
    assert barrier_segments(cols[:s], fused=False).tolist() == [0]


def test_reading_another_lane_of_the_own_slice_raises():
    cols = np.full((4, 3, 1), 6, dtype=np.int32)   # S = 2, R = 3: holes
    cols[1, 0, 0] = 3 + 1        # step 1 writes slice 1 and reads lane 1 of it
    with pytest.raises(ValueError, match="step 1"):
        barrier_segments(cols, fused=True)
    with pytest.raises(ValueError, match="2S"):
        barrier_segments(cols[:3], fused=True)


def test_wrapped_and_out_of_range_positions():
    """c in [-m, 0) wraps and ties like c + m; c outside [-m, m) reads
    nothing and ties nothing."""
    s, r = 3, 2
    m = s * r
    cols = np.full((s, r, 1), m, dtype=np.int32)
    cols[2, 0, 0] = 1 - m          # wraps to slice 0, lane 1
    assert barrier_segments(cols, fused=False).tolist() == [0, 2]
    cols[2, 0, 0] = -m - 1         # outside: reads nothing
    assert barrier_segments(cols, fused=False).tolist() == [0]


@pytest.mark.parametrize("seed", range(2))
def test_reads_of_unwritten_entries_are_masked(seed):
    """A forward step reading a slice that it or a later step writes reads
    the zero the step-major state starts from: the kernels mask those
    reads, so their output buffer needs no zero pass.  Random tables make
    such reads (there the unmasked NaN buffer shows); packed tables make
    none (the paper plans' emulation above starts from NaN too)."""
    cols, vals, dinv = _random_fused(4, 6, 2, seed)
    q = _rhs(cols, True, 2, seed)
    want = _plain(cols, vals, dinv, q, True)
    seg = barrier_segments(cols, True)
    np.testing.assert_array_equal(emulate(cols, vals, dinv, q, seg, True),
                                  want)
    assert np.isnan(emulate(cols, vals, dinv, q, seg, True,
                            mask=False)).any()
    # a sweep step reading its own entry, and a later slice, before either
    # is written
    s, r = 3, 2
    m = s * r
    sweep = np.full((s, r, 2), m, dtype=np.int32)
    sweep[1, 1] = (r + 1, 2 * r)
    vals, dinv = np.ones((s, r, 2)), np.ones((s, r))
    q = _rhs(sweep, False, 1, seed)
    want = _plain(sweep, vals, dinv, q, False)
    np.testing.assert_array_equal(
        emulate(sweep, vals, dinv, q, np.arange(s), False), want)
    assert np.isnan(emulate(sweep, vals, dinv, q, np.arange(s), False,
                            mask=False)).any()


def test_plain_wrappers_ignore_segments():
    """On the CPU every trisolve wrapper runs the step-major plain version,
    whatever cut it is given: the same bits with or without ``segments``."""
    _, cols, vals, dinv, _ = _tables("ieej")[0]
    q = _rhs(cols, True, 3, seed=1)
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (cols, vals, dinv, q)]
    want = hbmc_trisolve_fused_batched_ref(*t)
    want1 = hbmc_trisolve_fused_ref(*t[:3], t[3][..., 0].contiguous())
    for seg in (None, [0], np.arange(cols.shape[0])):
        assert torch.equal(hbmc_trisolve_fused_batched(*t, segments=seg),
                           want)
        assert torch.equal(hbmc_trisolve_fused(
            *t[:3], t[3][..., 0].contiguous(), segments=seg), want1)
    _, cols, vals, dinv, _ = _tables("ieej")[1]
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (cols, vals, dinv, _rhs(cols, False, 2, seed=2))]
    assert torch.equal(hbmc_trisolve_batched(*t, segments=[0]),
                       hbmc_trisolve_batched_ref(*t))
    q1 = t[3][..., 1].contiguous()
    want1 = hbmc_trisolve_ref(*t[:3], q1)
    for seg in (None, [0], np.arange(cols.shape[0])):
        assert torch.equal(hbmc_trisolve(*t[:3], q1, segments=seg), want1)


def _plan_arrays(plan):
    t, rm = plan._precond.tables, plan._rm
    return dict(cols=t.cols.numpy(), vals=t.vals.numpy(),
                dinv=t.dinv.numpy(), rows=rm.rows, pos=rm.pos,
                n_slots=rm.n_slots, sell_vals=plan._spmv_vals.numpy(),
                sell_cols=plan._spmv_cols.numpy(), sell_n=plan._spmv_n,
                n=plan.n, n_padded=plan.n_padded, perm=plan._perm,
                method=plan.method, n_colors=plan.n_colors)


def test_plans_carry_their_tables_segments():
    a = _thermal2(40)
    plan = build_plan(a, **KNOBS)
    t = plan._precond.tables
    want = barrier_segments(t.cols.numpy(), fused=True)
    assert "segments" not in vars(t)      # computed at first use only
    assert isinstance(t.segments, np.ndarray) and t.segments.dtype == np.int32
    np.testing.assert_array_equal(t.segments, want)
    assert t.segments is t.segments       # and kept
    # from_arrays: from the arrays' cols
    again = SolverPlan.from_arrays(_plan_arrays(plan), device="cpu")
    np.testing.assert_array_equal(again._precond.tables.segments, want)
    # refactor changes values, not cols: the same segments
    plan.refactor(sp.csr_matrix(a) * 2.0)
    np.testing.assert_array_equal(plan._precond.tables.segments, want)
    np.testing.assert_array_equal(plan._precond.tables.cols.numpy(),
                                  again._precond.tables.cols.numpy())

    plan_idx = build_plan(a, layout="index", **KNOBS)
    for sweep in (plan_idx._precond.kernel.fwd, plan_idx._precond.kernel.bwd):
        assert "segments" not in vars(sweep)
        np.testing.assert_array_equal(
            sweep.segments, barrier_segments(sweep.cols.numpy(), fused=False))
    before = [s.segments.copy() for s in (plan_idx._precond.kernel.fwd,
                                          plan_idx._precond.kernel.bwd)]
    plan_idx.refactor(sp.csr_matrix(a) * 3.0)
    for sweep, seg in zip((plan_idx._precond.kernel.fwd,
                           plan_idx._precond.kernel.bwd), before):
        np.testing.assert_array_equal(sweep.segments, seg)


def test_solve_paths_pass_the_tables_segments(monkeypatch):
    """Every apply, single-RHS and batched, in both layouts, hands the
    kernels its tables' own segments."""
    seen = []

    def spy(real):
        def call(*args, segments=None):
            seen.append(segments)
            return real(*args, segments=segments)
        return call

    for mod, name, real in (
            (trisolve, "hbmc_trisolve_fused", hbmc_trisolve_fused),
            (trisolve, "hbmc_trisolve_fused_batched",
             hbmc_trisolve_fused_batched),
            (ops, "hbmc_trisolve", hbmc_trisolve),
            (ops, "hbmc_trisolve_batched", hbmc_trisolve_batched)):
        monkeypatch.setattr(mod, name, spy(real))
    a = _thermal2(24)
    b = np.random.default_rng(0).normal(size=(a.shape[0], 2))
    plan = build_plan(a, **KNOBS)
    t = plan._precond.tables
    for solve, rhs in ((plan.solve, b[:, 0]), (plan.solve_batched, b)):
        solve(rhs)
        assert seen and all(s is t.segments for s in seen)
        seen.clear()
    plan_idx = build_plan(a, layout="index", **KNOBS)
    kp = plan_idx._precond.kernel
    for solve, rhs in ((plan_idx.solve, b[:, 0]),
                       (plan_idx.solve_batched, b)):
        solve(rhs)
        assert {id(s) for s in seen} == {id(kp.fwd.segments),
                                         id(kp.bwd.segments)}
        seen.clear()


@pytest.mark.parametrize("layout", ["round_major", "index"])
def test_refactor_keeps_the_tables_segments(monkeypatch, layout):
    """``refactor`` repacks the tables with the same ``cols``: the new
    tables carry the segments already computed, equal to a fresh analysis
    of their ``cols``, which does not run again; segments never computed
    stay lazy."""
    calls = []

    def counted(cols, fused):
        calls.append(fused)
        return barrier_segments(cols, fused)

    # every table's analysis runs through segments.table_segments
    monkeypatch.setattr(segments, "barrier_segments", counted)
    a = _thermal2(32)
    b = np.random.default_rng(1).normal(size=a.shape[0])
    plan = build_plan(a, layout=layout, **KNOBS)
    plan.refactor(sp.csr_matrix(a) * 1.5)          # before any solve
    assert all("segments" not in vars(x) for x in plan._step_tables())
    plan.solve(b)
    n_calls = len(calls)
    assert n_calls == (1 if layout == "round_major" else 2)
    before = plan._step_tables()
    old_vals = [t.vals.clone() for t in before]
    plan.refactor(sp.csr_matrix(a) * 2.0)
    after = plan._step_tables()
    fresh = build_plan(sp.csr_matrix(a) * 2.0, layout=layout,
                       **KNOBS)._step_tables()
    for was, now, old, new in zip(before, after, old_vals, fresh):
        # the new values go into the same tables (the tensors the captured
        # PCG graphs read), which keep their segments
        assert now is was and "segments" in vars(now)
        assert not torch.equal(now.vals, old)
        assert torch.equal(now.vals, new.vals)
        np.testing.assert_array_equal(
            now.segments, barrier_segments(now.cols.numpy(),
                                           fused=layout == "round_major"))
    again = plan.solve(2.0 * b)
    assert len(calls) == n_calls                   # the analysis did not rerun
    assert again.result.status == "CONVERGED"


# -- the single-RHS kernels' on-chip reads (segments.forwarded_reads) --------

def _own_chains(s, r, k, fused, seed):
    """Tables whose every read is of the reading lane's own entries (or the
    hole), at random distances back to the first step: one segment, any
    cut valid, and chains past ``RING_STEPS``; a third of the positions in
    their wrapped form."""
    rng = np.random.default_rng(seed)
    n_steps = 2 * s if fused else s
    m = s * r
    step = np.arange(n_steps)[:, None, None]
    back = fused & (step >= s)
    hi = np.where(back, s, np.maximum(step, 1))
    slc = (rng.random((n_steps, r, k)) * hi).astype(np.int64)
    cols = slc * r + np.arange(r)[None, :, None]
    cols = np.where(rng.random(cols.shape) < 0.3, cols - m, cols)
    hole = (rng.random(cols.shape) < 0.2) | ((step == 0) & ~back)
    return np.where(hole, m, cols).astype(np.int32)


def _walk_forwarded(cols, starts, fused):
    """forwarded_reads by brute force: walk the launches and their steps in
    the step-major order, keeping the step that last wrote each position,
    and mark a live read of the reading lane's own position whose last
    writer lies in the same launch, at most RING_STEPS back, in a launch
    of at least ON_CHIP_MIN_STEPS steps, of a table of at most
    ON_CHIP_MAX_K entries a row."""
    n_steps, r_, k_ = cols.shape
    s_ = n_steps // 2 if fused else n_steps
    m = s_ * r_
    dest = step_dest(n_steps, fused)
    lane = np.arange(r_)[:, None]
    writer = np.full(m, -1)
    out = np.zeros(cols.shape, dtype=bool)
    bounds = list(starts) + [n_steps]
    for g0, g1 in zip(bounds[:-1], bounds[1:]):
        for g in range(g0, g1):
            c = cols[g].astype(np.int64)
            c = np.where(c < 0, c + m, c)
            lim = g * r_ if (not fused or g < s_) else m
            own = (c >= 0) & (c < lim) & (c % r_ == lane)
            w = writer[np.where(own, c, 0)]
            out[g] = (own & (w >= g0) & (g - w <= segments.RING_STEPS)
                      & (g1 - g0 >= segments.ON_CHIP_MIN_STEPS)
                      & (k_ <= segments.ON_CHIP_MAX_K))
            writer[dest[g] * r_ + np.arange(r_)] = g
    return out


def _forward_case(case):
    """(label, cols, fused, cuts) of one case of the walk test."""
    kind, arg = case
    if kind == "paper":
        return [(lab, cols, fused,
                 [barrier_segments(cols, fused), np.arange(cols.shape[0])])
                for lab, cols, _, _, fused in _tables(arg)]
    if kind == "random":
        cols = _random_fused(4, 6, 2, arg)[0]
        return [("random", cols, True,
                 [barrier_segments(cols, True), np.arange(0, 8, 2)])]
    s = 40
    got = []
    for fused in (True, False):
        n_steps = 2 * s if fused else s
        cols = _own_chains(s, 9, arg, fused, seed=arg)
        cuts = [np.array([0]), np.arange(n_steps), np.arange(0, n_steps, 2),
                np.arange(0, n_steps, 16), np.arange(0, n_steps, 32),
                np.array([0, 5, 7, 30])]
        if fused:      # a launch across the turn
            cuts.append(np.array([0, s - 9, s + 23]))
        got.append((f"chains fused={fused}", cols, fused, cuts))
    return got


@pytest.mark.parametrize("case", [("paper", n) for n in PAPER_PROBLEMS]
                         + [("random", 0), ("random", 1), ("chains", 1),
                            ("chains", 6), ("chains", 8), ("chains", 11)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_forwarded_reads_match_a_step_major_walk(case):
    """The closed form of the kernels' rule (the latest writer of slice x
    before step g is x, or the fused table's backward step 2S-1-x if that
    is before g) against a walk that tracks every position's writer: paper
    plans with their cut and one launch per step, random tables with many
    ties, and own-lane chains cut into launches of 1, 2, 16, 32 and all
    steps, and across the fused table's turn; rows of 11 entries (past
    ON_CHIP_MAX_K) take the plain path, and none is served."""
    seen, eligible = 0, False
    for lab, cols, fused, cuts in _forward_case(case):
        eligible |= cols.shape[2] <= segments.ON_CHIP_MAX_K
        for cut in cuts:
            got = segments.forwarded_reads(cols, cut, fused)
            np.testing.assert_array_equal(
                got, _walk_forwarded(cols, cut, fused),
                err_msg=f"{lab} cut {list(cut)[:8]}")
            seen += got.sum()
    if case[0] != "random":
        assert (seen > 0) == eligible


def test_forwarded_reads_chains_past_the_ring_read_y():
    """A chain back to the first step in one launch: every own-lane read is
    in the launch, but only those at most RING_STEPS back are served."""
    s, r = 40, 9
    cols = _own_chains(s, r, 6, True, seed=3)
    m = s * r
    c = np.where(cols < 0, cols + m, cols).astype(np.int64)
    live = c < m
    got = segments.forwarded_reads(cols, [0], True)
    assert got.sum() < live.sum()
    assert not segments.forwarded_reads(cols, np.arange(2 * s), True).any()


def test_forwarded_reads_on_the_thermal2_cell_plan():
    """The thermal2 cell's plan cut to 300^2 (P1 triangles, block 16, w 8,
    f64): 9 launches of 8-32 steps an apply, and 31% of the live gathers
    read what the same launch wrote, 94% of them one step back."""
    path = (Path(__file__).resolve().parents[1] / "portbench" / "matrices"
            / "fem2d_p1_lognormal.py")
    spec = importlib.util.spec_from_file_location("_fem2d_p1", path)
    fem = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fem)
    a = fem.make({"nx": 300, "ny": 300, "sigma": 1.0},
                 np.random.default_rng(0))
    t = build_plan(a, **KNOBS)._precond.tables
    cols = t.cols.numpy()
    assert cols.shape == (128, 1465, 6)
    seg = barrier_segments(cols, True)
    assert seg.tolist() == [0, 16, 24, 32, 48, 80, 96, 104, 112]
    m = 64 * 1465
    c = np.where(cols < 0, cols + m, cols).astype(np.int64)
    g = np.arange(128)[:, None, None]
    live = (c >= 0) & (c < np.where(g < 64, g * 1465, m))
    served = segments.forwarded_reads(cols, seg, True)
    assert (int(served.sum()), int(live.sum())) == (164_616, 537_602)
    assert round(served.sum() / live.sum(), 3) == 0.306
    x = c // 1465
    w = np.where((g >= 64) & (127 - x < g), 127 - x, x)
    assert int((served & (g - w == 1)).sum()) == 155_002
    assert not (served & ~live).any()


def test_on_chip_constants_mirror_the_kernel_source():
    """The kernels' own bounds that ``single_paths`` and
    ``forwarded_reads`` rely on: rows of at most KP entries on chip, a ring
    of RING_STEPS outputs, groups of at most GROUP_MAX threads."""
    src = (Path(segments.__file__).resolve().parent / "csrc"
           / "hbmc_trisolve.cu").read_text()
    for name, there in (("ON_CHIP_MAX_K", "KP"), ("RING_STEPS", "RING_STEPS"),
                        ("GROUP_MAX", "GROUP_MAX")):
        got = re.search(rf"constexpr int {there} = (\d+);", src)
        assert got, name
        assert int(got.group(1)) == getattr(segments, name), name
    for gone in ("ON_CHIP_MIN_STEPS", "GROUP_THREADS", "lane_group"):
        assert gone not in src, gone


# -- the lane-group rule (segments.lane_group) --------------------------------

@pytest.mark.parametrize("shape, group", [
    ((80, 1_580), 32),        # the audikw_1 cell's fused table
    ((80, 111), 32),          # its plan at 16 bricks a side
    ((15, 140_700), 1),       # the g3_circuit cell's (R about 21.3 n / 240)
    ((6, 19_424), 1),         # the thermal2 cell's: K <= ON_CHIP_MAX_K
    ((4, 32_768), 1),         # the 1M laplace plan's
], ids=["audikw_1", "audikw_1-16", "g3_circuit", "thermal2", "laplace-1m"])
def test_lane_group_on_the_cells_tables(shape, group):
    assert segments.lane_group(*shape) == group


@pytest.mark.parametrize("k, r, group", [
    # K: at ON_CHIP_MAX_K a thread a lane, past it the largest power of
    # two not above K
    (8, 1, 1), (9, 1, 8), (15, 1, 8), (16, 1, 16), (31, 1, 16), (32, 1, 32),
    (129, 1, 32), (1, 1, 1),
    # R x G <= GROUP_THREADS (135,168): at the edge and one lane past it
    (80, 4_224, 32), (80, 4_225, 16), (80, 8_448, 16), (80, 8_449, 8),
    (80, 67_584, 2), (80, 67_585, 1), (9, 16_896, 8), (9, 16_897, 4),
    (11, 200_000, 1),
])
def test_lane_group_edges(k, r, group):
    """Each condition of the rule at its edge: G <= GROUP_MAX, G <= K, R x
    G <= GROUP_THREADS; G = 1 wherever K <= ON_CHIP_MAX_K."""
    assert segments.lane_group(k, r) == group
    g = segments.lane_group(k, r)
    if g > 1:
        assert g & (g - 1) == 0 and g <= min(segments.GROUP_MAX, k)
        assert r * g <= segments.GROUP_THREADS
        assert (2 * g > min(segments.GROUP_MAX, k)
                or r * 2 * g > segments.GROUP_THREADS)


# -- the path of each single-RHS launch (segments.single_paths) -------------

@pytest.mark.parametrize("k, r, s, starts, fused, want", [
    # the audikw_1 cell's fused table (480, 1,580, 80): every launch on
    # lane groups of 32
    (80, 1_580, 240, [0, 1, 3, 40, 300], True, [32] * 5),
    # the thermal2 cell's (K = 6, R 19,424): on chip from 3 steps
    (6, 19_424, 64, [0, 16, 17, 19, 22, 80], True, [1, 0, 0, 1, 1, 1]),
    # the g3_circuit cell's (K = 15, R 141,886): no group fits, plain
    (15, 141_886, 240, [0, 1, 2, 10, 300], True, [0] * 5),
    # segments of 2 and 3 steps, a sweep and a fused table
    (4, 100, 5, [0, 2], False, [0, 1]),
    (4, 100, 5, [0, 3, 5, 8], True, [1, 0, 1, 0]),
    # K at ON_CHIP_MAX_K and one past it
    (8, 100, 8, [0, 1, 4], False, [0, 1, 1]),
    (9, 100, 8, [0, 1, 4], False, [8, 8, 8]),
    # K = 1, and an empty row: plain
    (1, 100, 8, [0], False, [1]),
    (0, 100, 8, [0], False, [0]),
    # R x G at GROUP_THREADS and one lane past it
    (80, 4_224, 4, [0, 2], True, [32, 32]),
    (80, 4_225, 4, [0, 2], True, [16, 16]),
    # S x R below 2^31 and at it: no group, and K past the on-chip path
    (80, 1, 2**31 - 1, [0], False, [32]),
    (80, 2, 2**30, [0], False, [0]),
    # steps x R x K below 2^31 and at it: no on-chip path
    (8, 2**20, 127, [0], True, [1]),
    (8, 2**20, 128, [0], True, [0]),
    (8, 2**20, 255, [0, 100], False, [1, 1]),
    (8, 2**20, 256, [0, 100], False, [0, 0]),
], ids=["audikw_1", "thermal2", "g3_circuit", "lengths-2-3-sweep",
        "lengths-2-3-fused", "k8", "k9", "k1", "k0", "rg-at-cap",
        "rg-past-cap", "sr-below-2^31", "sr-at-2^31", "entries-below-2^31",
        "entries-at-2^31", "sweep-entries-below-2^31",
        "sweep-entries-at-2^31"])
def test_single_paths(k, r, s, starts, fused, want):
    got = segments.single_paths(k, r, s, np.asarray(starts, np.int32), fused)
    assert got.dtype == np.int32
    assert got.tolist() == want
