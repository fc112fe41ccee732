"""The port's analysis package against ``repro.analysis``, on the CPU.

Mirrors ``tests/test_analysis.py`` and ``tests/test_numerics_analysis.py``
case for case where the port has a counterpart; the inputs come from the
reference's own packing of numpy-seeded matrices, so both packages see the
same arrays:

  1. **verdict parity**: every schedule check on the reference's tampered
     inputs (row swap, merged colors, duplicate / unscheduled rows,
     reversed backward rounds, premature read, dropped dependency,
     self-read, IC(0) reorder) returns the identical ``Violation`` list
     (kind, where, round, rows, edge, detail), on numpy arrays and on torch
     tensors;
  2. **completeness**: ``validate`` in all four modes proves the five
     paper generators at ``scale="tiny"`` x hbmc, bmc, mc x both layouts
     clean in both packages, and gates ``build_plan``, ``PlanCache`` and
     ``SolverService``;
  3. **segment cuts** (the port's own check): ``check_segments`` accepts
     ``barrier_segments``' starts and the per-step cut, and flags a
     coarser cut and a same-slice read of another lane, both of which the
     reference's positional ``check_fused_tables`` accepts;
  4. **kernel checks, traffic, bench gate**: the reference's verdicts on
     corrupted operands, its static traffic terms, its gate verdicts on the
     committed and doctored snapshots; the port's own kinds (int32 range,
     grids, contiguity) and its measured kernel terms;
  5. **linters**: the op budgets, the dtype flow and the collective
     structure pass on clean CPU paths (kernels as opaque nodes) and name
     the doctored op;
  6. **CLI**: exit 0 on a clean run, 1 on a tampered one.

Tolerances: none; every comparison is exact (verdicts, byte counts).
"""
import ast
import copy
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro.analysis as j_analysis
from repro.analysis import check_fused_tables as j_check_fused_tables
from repro.analysis import traffic_report as j_traffic_report
from repro.analysis import validate_plan as j_validate_plan
from repro.core import build_plan as j_build_plan
from repro.core import fuse_round_major as j_fuse_round_major
from repro.core import ic0 as j_ic0
from repro.core import pack_factor as j_pack_factor
from repro.core import pack_sell as j_pack_sell
from repro.core.ic0 import ic0_structure as j_ic0_structure
from repro.core.matrices import PAPER_PROBLEMS, PAPER_SHIFTS, laplace_2d
from repro.core.matrices import paper_problem
from repro.core.solvers import _order_system as j_order_system
from repro_torch import analysis
from repro_torch.analysis import (DISTRIBUTED_APPLY, FULL_PALLAS_ITERATION,
                                  PALLAS_SPMV, PRECONDITIONED_ITERATION,
                                  ROUND_MAJOR_APPLY, VALIDATE_MODES,
                                  ContractError, PrecisionContract,
                                  PrimitiveBudget, ScheduleError,
                                  assert_budget, assert_plan_dtype_flow,
                                  assert_plan_valid, bench_gate,
                                  check_collectives, check_fused_tables,
                                  check_plan_collectives,
                                  check_plan_dtype_flow, check_plan_kernels,
                                  check_plan_traffic, check_segments,
                                  check_sell_spmv, check_shard_block,
                                  check_shard_step, check_trisolve_fused,
                                  check_trisolve_sweep, compare_traffic,
                                  contract_for_plan, lint, lint_dtype_flow,
                                  plan_launches, primitive_counts,
                                  recaptures, sweep_step_tables,
                                  traffic_report, validate_plan)
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.dtype_flow import nonzero_rhs
from repro_torch.core import (SolverPlan, build_plan, pcg_iteration,
                              solve_iccg)
from repro_torch.core.sell import pack_factor
from repro_torch.kernels import hbmc_trisolve_fused
from repro_torch.kernels.segments import barrier_segments
from repro_torch.serve import PlanCache, SolverService, VirtualClock

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "benchmarks"
PLAN = dict(block_size=8, w=4, device="cpu")
METHODS = ("hbmc", "bmc", "mc")
LAYOUTS = ("round_major", "index")


def _rows(violations) -> list[tuple]:
    """A violation list as comparable tuples (kind, where, round, rows,
    edge, detail), across the two packages' Violation classes."""
    return [(v.kind, v.where, v.round,
             None if v.rows is None else tuple(int(x) for x in v.rows),
             None if v.edge is None else tuple(int(x) for x in v.edge),
             v.detail) for v in violations]


def _system(method, nx=13, ny=11, bs=8, w=4):
    a = laplace_2d(nx, ny)
    sysd = j_order_system(sp.csr_matrix(a), None, method, bs, w)
    return a, sysd, j_ic0(sysd.a_bar)


def _dependent_pair(sysd):
    """A DAG edge (j -> i) whose endpoints sit in different rounds."""
    low = sp.tril(sp.csr_matrix(sysd.a_bar), k=-1).tocoo()
    round_of = {}
    for s, r in enumerate(sysd.fwd_rounds):
        for row in r:
            round_of[int(row)] = s
    for j, i, v in zip(low.col, low.row, low.data):
        j, i = int(j), int(i)
        if v != 0 and j in round_of and i in round_of \
                and round_of[j] != round_of[i]:
            return j, i
    raise AssertionError("no cross-round dependency edge found")


def _swap_rows_in_place(rounds, i, j):
    for r in rounds:
        mi, mj = r == i, r == j
        r[mi] = j
        r[mj] = i


# ---------------------------------------------------------------------------
# 1. Verdict parity on the reference's tampered inputs.
# ---------------------------------------------------------------------------

def _case_row_swap():
    _, sysd, _ = _system("mc")
    j, i = _dependent_pair(sysd)
    _swap_rows_in_place(sysd.fwd_rounds, i, j)
    return "check_rounds", (sysd.a_bar, sysd.fwd_rounds), \
        dict(drop_mask=sysd.drop), "cross-round-order"


def _case_merged_colors():
    _, sysd, _ = _system("mc")
    merged = [np.concatenate(sysd.fwd_rounds[:2])] + sysd.fwd_rounds[2:]
    return "check_rounds", (sysd.a_bar, merged), dict(drop_mask=sysd.drop), \
        "intra-round-edge"


def _case_duplicate_unscheduled():
    _, sysd, _ = _system("mc")
    rounds = [r.copy() for r in sysd.fwd_rounds]
    rounds[0] = rounds[0][1:]
    rounds[1] = np.concatenate([rounds[1], [int(rounds[1][0])]])
    return "check_rounds", (sysd.a_bar, rounds), dict(drop_mask=sysd.drop), \
        "duplicate-row"


def _case_clean_rounds():
    _, sysd, _ = _system("hbmc")
    return "check_rounds", (sysd.a_bar, sysd.fwd_rounds), \
        dict(drop_mask=sysd.drop), None


def _case_backward_not_reversed():
    _, sysd, _ = _system("hbmc")
    return "check_reversed_rounds", (sysd.fwd_rounds, sysd.bwd_rounds[::-1]), \
        {}, "backward-not-reversed"


def _case_premature_read():
    _, sysd, l_bar = _system("hbmc")
    fwd, _ = j_pack_factor(l_bar, sysd.fwd_rounds, sysd.bwd_rounds, sysd.drop)
    late_row = int(np.asarray(sysd.fwd_rounds[-1])[0])
    fwd.cols[0, 0, 0] = late_row
    fwd.vals[0, 0, 0] = 1.0
    return "check_step_tables", (fwd,), {}, "premature-read"


def _case_dropped_dependency():
    _, sysd, l_bar = _system("mc")
    tri = sp.tril(sp.csr_matrix(l_bar), k=-1, format="csr")
    fwd, _ = j_pack_factor(l_bar, sysd.fwd_rounds, sysd.bwd_rounds, sysd.drop)
    s, t, k = (int(x) for x in np.argwhere(fwd.vals != 0)[0])
    fwd.vals[s, t, k] = 0.0
    return "check_step_tables", (fwd,), dict(tri=tri), "dropped-dependency"


def _case_clean_steps():
    _, sysd, l_bar = _system("mc")
    tri = sp.tril(sp.csr_matrix(l_bar), k=-1, format="csr")
    fwd, _ = j_pack_factor(l_bar, sysd.fwd_rounds, sysd.bwd_rounds, sysd.drop)
    return "check_step_tables", (fwd,), dict(tri=tri), None


def _fused(method="hbmc"):
    _, sysd, l_bar = _system(method)
    return j_fuse_round_major(*j_pack_factor(l_bar, sysd.fwd_rounds,
                                             sysd.bwd_rounds, sysd.drop))


def _case_self_read():
    fused = _fused()
    lay = fused.layout
    g, t = 1, 0
    pos = g * lay.lanes + t
    fused.cols[g, t, 0] = pos
    fused.vals[g, t, 0] = 1.0
    return "check_fused_tables", (fused,), {}, "premature-read"


def _case_clean_fused():
    return "check_fused_tables", (_fused(),), {}, None


def _case_ic0_reorder():
    _, sysd, _ = _system("mc")
    st = j_ic0_structure(sysd.a_bar, sysd.fwd_rounds)
    bad = dataclasses.replace(st, steps=list(reversed(st.steps)))
    return "check_ic0_structure", (bad,), {}, "premature-read"


CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_row_swap, _case_merged_colors, _case_duplicate_unscheduled,
    _case_clean_rounds, _case_backward_not_reversed, _case_premature_read,
    _case_dropped_dependency, _case_clean_steps, _case_self_read,
    _case_clean_fused, _case_ic0_reorder)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_checks_give_the_reference_verdicts(case):
    """Each check of the port returns the reference's witness list, in the
    reference's order, on the reference's (tampered) inputs."""
    fn, args, kwargs, kind = CASES[case]()
    want = getattr(j_analysis, fn)(*args, **kwargs)
    got = getattr(analysis, fn)(*args, **kwargs)
    assert _rows(got) == _rows(want)
    if kind is None:
        assert got == []
    else:
        assert kind in {v.kind for v in got}, _rows(got)


@pytest.mark.parametrize("case", ["self_read", "clean_fused"])
def test_fused_check_takes_torch_tensors(case):
    """The port's tables are tensors: one host copy at entry, the same
    verdict as on the numpy arrays."""
    _, (fused,), _, _ = CASES[case]()
    tensors = dataclasses.replace(fused, cols=torch.tensor(fused.cols),
                                  vals=torch.tensor(fused.vals))
    assert _rows(check_fused_tables(tensors)) == \
        _rows(j_check_fused_tables(fused))


def test_row_swap_witness_names_the_edge():
    _, sysd, _ = _system("mc")
    j, i = _dependent_pair(sysd)
    _swap_rows_in_place(sysd.fwd_rounds, i, j)
    vio = analysis.check_rounds(sysd.a_bar, sysd.fwd_rounds,
                                drop_mask=sysd.drop)
    assert any(v.kind == "cross-round-order" and v.edge == (j, i)
               for v in vio)


# ---------------------------------------------------------------------------
# 2. Completeness: the paper generators prove clean in both packages, and
#    the proof gates build_plan, PlanCache and SolverService.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("problem", PAPER_PROBLEMS)
def test_paper_generators_prove_race_free(problem, method, layout):
    """Every mode, both packages: the port's build-time proof (held host
    tables) and its proof of a built plan (device tables) alike."""
    a, _ = paper_problem(problem, "tiny")
    kw = dict(method=method, shift=PAPER_SHIFTS.get(problem, 0.0),
              layout=layout)
    jp = j_build_plan(a, **kw)
    plan = build_plan(a, validate="full", **kw, device="cpu")
    assert plan.validate == "full"
    for mode in VALIDATE_MODES:
        assert j_validate_plan(jp, mode) == []
        assert validate_plan(plan, mode) == [], mode


def test_index_plan_device_tables_map_back_to_step_tables():
    """``sweep_step_tables`` of the index layout's device sweeps gives back
    the host ``StepTables`` the build packed (rows, cols, vals)."""
    a, _ = paper_problem("thermal2", "tiny")
    plan = build_plan(a, method="hbmc", layout="index", **PLAN)
    sysd = plan._sysd
    l_bar = plan._factor(sysd.a_bar)
    fwd_h, bwd_h = pack_factor(l_bar, sysd.fwd_rounds, sysd.bwd_rounds,
                               sysd.drop)
    for host, dev in ((fwd_h, plan._precond.kernel.fwd),
                      (bwd_h, plan._precond.kernel.bwd)):
        back = sweep_step_tables(dev)
        np.testing.assert_array_equal(back.rows, host.rows)
        np.testing.assert_array_equal(back.cols, host.cols)
        np.testing.assert_array_equal(back.vals, host.vals)


@pytest.mark.parametrize("entry", ["build_plan", "PlanCache",
                                   "SolverService", "solve_iccg"])
def test_unknown_validate_mode_raises(entry):
    a = laplace_2d(6, 5)
    make = {"build_plan": lambda: build_plan(a, method="mc",
                                             validate="banana", **PLAN),
            "PlanCache": lambda: PlanCache(validate="banana"),
            "SolverService": lambda: SolverService(validate="banana"),
            "solve_iccg": lambda: solve_iccg(a, np.ones(a.shape[0]),
                                             validate="banana", **PLAN)}
    with pytest.raises(ValueError, match="validate"):
        make[entry]()


def test_tampered_plan_fails_validation_as_the_reference():
    a = laplace_2d(13, 11)
    jp = j_build_plan(a, method="mc")
    plan = build_plan(a, method="mc", validate="full", **PLAN)
    j, i = _dependent_pair(plan._sysd)
    for p in (jp, plan):
        _swap_rows_in_place(p._sysd.fwd_rounds, i, j)
        _swap_rows_in_place(p._sysd.bwd_rounds, i, j)
    with pytest.raises(ScheduleError) as exc:
        assert_plan_valid(plan, "cheap", context="tampered")
    assert any(v.kind == "cross-round-order" and v.edge == (j, i)
               for v in exc.value.violations)
    assert "tampered" in str(exc.value)
    assert _rows(validate_plan(plan, "full")) == \
        _rows(j_validate_plan(jp, "full"))


def test_tampered_device_tables_fail_full_validation():
    """"full" reads the tables the kernels launch: a forward step reading
    its own slot, written into the plan's device tables, is witnessed."""
    plan = build_plan(laplace_2d(13, 11), method="hbmc", **PLAN)
    t = plan._precond.tables
    g, lane = 1, 0
    pos = g * t.lanes + lane
    t.cols[g, lane, 0] = pos
    t.vals[g, lane, 0] = 1.0
    vio = validate_plan(plan, "full")
    assert any(v.kind == "premature-read" and v.edge == (pos, pos)
               and v.where == "fused_tables" for v in vio), _rows(vio)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_cache_admission_rejects_racy_plans(layout):
    a = laplace_2d(9, 8)

    def sabotaged_build(a_, **knobs):
        plan = build_plan(a_, **knobs)
        j, i = _dependent_pair(plan._sysd)
        _swap_rows_in_place(plan._sysd.fwd_rounds, i, j)
        _swap_rows_in_place(plan._sysd.bwd_rounds, i, j)
        return plan

    knobs = dict(method="mc", layout=layout, **PLAN)
    cache = PlanCache(capacity=2, build=sabotaged_build, validate="full")
    with pytest.raises(ScheduleError):
        cache.get(a, **knobs)
    # the racy plan never entered the cache: no later hit can dispatch it
    assert len(cache) == 0

    clean = PlanCache(capacity=2, validate="full")
    _, status = clean.get(a, **knobs)
    assert status == "miss" and len(clean) == 1
    _, status = clean.get(a, **knobs)
    assert status == "hit"                   # admission runs on misses only


def test_segment_race_is_refused_at_admission():
    """A plan whose fused table carries a cut coarser than its ties passes
    the reference's checks but not the port's admission."""
    a = laplace_2d(9, 8)

    def coarse_build(a_, **knobs):
        plan = build_plan(a_, **knobs)
        plan._precond.tables.segments = np.zeros(1, dtype=np.int32)
        return plan

    cache = PlanCache(build=coarse_build, validate="full")
    with pytest.raises(ScheduleError) as exc:
        cache.get(a, method="hbmc", **PLAN)
    assert {v.kind for v in exc.value.violations} == {"segment-race"}
    assert len(cache) == 0


def test_service_validates_admission():
    a = laplace_2d(9, 8)
    knobs = dict(method="hbmc", **PLAN)
    svc = SolverService(clock=VirtualClock(), validate="deep", **knobs)
    assert svc.cache.validate == "deep"
    rid = svc.submit(a, np.ones(a.shape[0]))
    svc.drain()
    assert svc.completed[rid].status == "CONVERGED"
    # a given cache keeps its own mode; a different one is refused
    with pytest.raises(ValueError, match="validate"):
        SolverService(cache=PlanCache(validate="cheap"), validate="full")
    assert SolverService(cache=PlanCache(validate="full"),
                         validate="full").cache.validate == "full"


def test_from_arrays_plan_refuses_validation():
    plan = build_plan(laplace_2d(9, 8), method="hbmc", **PLAN)
    t = plan._precond.tables
    arrays = dict(cols=t.cols.numpy(), vals=t.vals.numpy(),
                  dinv=t.dinv.numpy(), rows=plan._rm.rows, pos=plan._rm.pos,
                  n_slots=plan._rm.n_slots,
                  sell_vals=plan._spmv_vals.numpy(),
                  sell_cols=plan._spmv_cols.numpy(), sell_n=plan._spmv_n,
                  perm=plan._perm, n=plan.n, n_padded=plan.n_padded)
    other = SolverPlan.from_arrays(arrays, device="cpu")
    assert other.validate == "off"
    with pytest.raises(ValueError, match="from_arrays"):
        validate_plan(other, "cheap")
    assert validate_plan(other, "off") == []


# ---------------------------------------------------------------------------
# 3. Segment cuts: the race the reference's positional proof cannot see.
# ---------------------------------------------------------------------------

def _plan_tables(problem, scheduler="coloring"):
    a, _ = paper_problem(problem, "tiny")
    kw = dict(method="hbmc", shift=PAPER_SHIFTS.get(problem, 0.0),
              scheduler=scheduler, **PLAN)
    fused = build_plan(a, **kw)._precond.tables
    kernel = build_plan(a, layout="index", **kw)._precond.kernel
    return [(fused.cols.numpy(), True), (kernel.fwd.cols.numpy(), False),
            (kernel.bwd.cols.numpy(), False)]


@pytest.mark.parametrize("scheduler", ["coloring", "levelset"])
@pytest.mark.parametrize("problem", PAPER_PROBLEMS)
def test_check_segments_accepts_greedy_and_per_step_cuts(problem,
                                                         scheduler):
    for cols, fused in _plan_tables(problem, scheduler):
        assert check_segments(cols, barrier_segments(cols, fused),
                              fused) == []
        assert check_segments(cols, np.arange(cols.shape[0]), fused) == []


def test_check_segments_flags_a_coarser_cut_the_reference_accepts():
    """Dropping the middle start of the fused table's cut merges two
    segments: a step then reads another lane's entry of a slice written in
    the same launch.  The tables themselves are unchanged, so the
    reference's check of them returns [] -- the race lives in the cut,
    which only the card has."""
    a, _ = paper_problem("thermal2", "tiny")
    plan = build_plan(a, method="hbmc", **PLAN)
    t = plan._precond.tables
    cols = t.cols.numpy()
    seg = barrier_segments(cols, True)
    assert seg.size >= 3
    coarse = np.delete(seg, seg.size // 2)
    vio = check_segments(cols, coarse, True, where="segments/fused")
    assert vio and {v.kind for v in vio} == {"segment-race"}
    r_ = cols.shape[1]
    s_ = cols.shape[0] // 2
    for v in vio:
        reader, writer = v.rows
        pos, lane = v.edge
        assert v.round == reader
        assert pos % r_ != lane                 # another lane's entry
        assert pos // r_ in (writer, 2 * s_ - 1 - writer)  # slice written
        assert cols[reader, lane].tolist().count(pos) \
            + cols[reader, lane].tolist().count(pos - s_ * r_) >= 1
    tables = types.SimpleNamespace(cols=cols, vals=t.vals.numpy())
    assert j_check_fused_tables(tables) == []
    plan._precond.tables.segments = coarse
    assert {v.kind for v in validate_plan(plan, "full")} == {"segment-race"}


def test_check_segments_flags_a_same_slice_read_the_reference_accepts():
    """Forward step g, lane 1 reading lane 0's entry of slice g: below its
    destination, so the reference's positional proof accepts it; on the
    card the two lanes of one launch run in no order, and no cut can order
    a step against itself."""
    fused = _fused()
    r_ = fused.cols.shape[1]
    g, lane = 1, 1
    assert fused.layout.rows[g, lane] != fused.layout.n_slots - 1
    fused.cols[g, lane, 0] = g * r_          # lane 0 of the same slice
    fused.vals[g, lane, 0] = 1.0
    assert j_check_fused_tables(fused) == []
    assert check_fused_tables(fused) == []   # the reference's verdict
    vio = check_segments(fused.cols, np.arange(fused.cols.shape[0]), True)
    assert _rows(vio)[0][:5] == ("intra-step-read", "segments", g, (g, g),
                                 (g * r_, lane))
    with pytest.raises(ScheduleError, match="step 1") as exc:
        barrier_segments(fused.cols, True)
    assert isinstance(exc.value, ValueError)
    assert exc.value.violations[0].kind == "intra-step-read"


@pytest.mark.parametrize("fused", [False, True])
def test_check_segments_needs_a_start_after_the_writer(fused):
    """The smallest tie: step 1, lane 0 reads lane 1's entry of slice 0,
    which step 0 writes (and, in a fused table, step 3).  A start at the
    writer's step does not order the tie; one after it does."""
    s_, r_ = 2, 2
    m = s_ * r_
    cols = np.full((2 * s_ if fused else s_, r_, 1), m, dtype=np.int32)
    cols[1, 0, 0] = 1
    vio = check_segments(cols, [0], fused)
    assert [(v.kind, v.round, v.rows, v.edge) for v in vio] == \
        [("segment-race", 1, (1, 0), (1, 0))] \
        + [("segment-race", 1, (1, 3), (1, 0))] * fused
    greedy = barrier_segments(cols, fused)
    assert greedy.tolist() == ([0, 1, 3] if fused else [0, 1])
    assert check_segments(cols, greedy, fused) == []
    assert [v.rows for v in check_segments(cols, [0, 1], fused)] == \
        [(1, 3)] * fused


@pytest.mark.parametrize("starts", [[1], [0, 0], [0, 5, 3], [0, 10**6], []])
def test_check_segments_flags_a_malformed_cut(starts):
    cols = _fused().cols
    vio = check_segments(cols, starts, True)
    assert [v.kind for v in vio] == ["segment-form"]


# ---------------------------------------------------------------------------
# 4. Kernel checks, traffic and the bench gate.
# ---------------------------------------------------------------------------

def _j_tables():
    jp = j_build_plan(laplace_2d(10, 8), method="hbmc", block_size=8, w=4,
                      spmv_format="sell", backend="pallas",
                      spmv_backend="pallas", interpret=True)
    t = jp._precond.tables
    return (np.asarray(t.cols).copy(), np.asarray(t.vals).copy(),
            np.asarray(t.dinv).copy())


def _corrupt(name):
    cols, vals, dinv = _j_tables()
    m = (cols.shape[0] // 2) * cols.shape[1]
    if name == "oob":
        cols[0, 0, 0] = m + 5
    elif name == "live-hole":
        vals[cols == m] = 1.0
    elif name == "odd":
        cols, vals, dinv = cols[:-1], vals[:-1], dinv[:-1]
    elif name == "negative":
        cols[3, 0, 0] = -2
    return cols, vals, dinv


@pytest.mark.parametrize("name", ["clean", "oob", "live-hole", "odd",
                                  "negative"])
def test_trisolve_kernel_checks_give_the_reference_verdicts(name):
    cols, vals, dinv = _corrupt(name)
    want = [v.kind for v in j_analysis.check_trisolve_fused(cols, vals,
                                                            dinv)]
    got = [v.kind for v in check_trisolve_fused(cols, vals, dinv)]
    assert got == want
    assert bool(got) == (name != "clean")


def test_sell_kernel_checks_give_the_reference_verdicts():
    a = laplace_2d(10, 8)
    sm = j_pack_sell(a, 4)
    n_pad = sm.cols.shape[0] * sm.w
    assert check_sell_spmv(sm.vals, sm.cols, n_pad=n_pad) == []
    cols_bad = sm.cols.copy()
    s, k, w = (int(x) for x in np.argwhere(sm.vals != 0)[0])
    cols_bad[s, k, w] = 10**6
    want = [v.kind for v in j_analysis.check_sell_spmv(sm.vals, cols_bad,
                                                       n_pad=n_pad)]
    got = [v.kind for v in check_sell_spmv(sm.vals, cols_bad, n_pad=n_pad)]
    assert got == want == ["index-bounds"]
    assert check_sell_spmv(sm.vals, sm.cols, n_pad=n_pad, batch=8) == []


def test_kernel_checks_of_the_card_launches():
    """The port's own kinds: what the CUDA launches need of the operands."""
    cols, vals, dinv = (torch.tensor(x) for x in _j_tables())
    assert check_trisolve_fused(cols, vals, dinv) == []
    strided = cols.transpose(0, 1).contiguous().transpose(0, 1)
    assert [v.kind for v in check_trisolve_fused(strided, vals, dinv)] == \
        ["non-contiguous"]
    assert "operand-dtype" in {v.kind for v in check_trisolve_fused(
        cols, vals.to(torch.float32), dinv)}
    assert [v.kind for v in check_trisolve_fused(cols.long(), vals, dinv)] \
        == ["index-dtype"]
    # S*R past int32: the positions cannot address the state
    big = np.broadcast_to(np.int32(0), (2, 2**31 // 2 + 1, 1))
    bigf = np.broadcast_to(0.0, big.shape)
    kinds = {v.kind for v in check_trisolve_sweep(
        big, bigf, np.broadcast_to(0.0, big.shape[:2]))}
    assert "int32-range" in kinds
    # R * B threads past gridDim.x blocks of 256
    wide = np.broadcast_to(np.int32(0), (2, 2**20, 1))
    widef = np.broadcast_to(0.0, wide.shape)
    vio = check_trisolve_fused(wide, widef,
                               np.broadcast_to(0.0, wide.shape[:2]),
                               batch=2**20)
    assert "grid" in {v.kind for v in vio}
    # a shard step's lane block must lie inside the state's lanes
    s2, r_, _ = cols.shape
    block = [x[:, :r_ // 2].contiguous() for x in (cols, vals, dinv)]
    assert check_shard_step(*block, r_full=r_, lane0=r_ // 2) == []
    assert "shape-mismatch" in {v.kind for v in check_shard_step(
        *block, r_full=r_, lane0=r_)}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_kernels_clean_and_launches_reported(layout):
    plan = build_plan(laplace_2d(13, 11), method="hbmc", layout=layout,
                      **PLAN)
    for batch in (1, 8):
        assert check_plan_kernels(plan, batch=batch) == []
        launches = plan_launches(plan, batch=batch)
        assert all(x["blocks"] >= 1 and x["threads"] in (128, 256)
                   and x["launches"] >= 1 for x in launches)
    names = [x["name"] for x in plan_launches(plan)]
    assert names == (["hbmc_trisolve_fused", "sell_spmv"]
                     if layout == "round_major" else
                     ["hbmc_trisolve (fwd)", "hbmc_trisolve (bwd)",
                      "sell_spmv"])
    t = plan._step_tables()[0]
    assert plan_launches(plan)[0]["launches"] == t.segments.size


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("spmv_format", ["sell", "ell"])
def test_static_traffic_terms_equal_the_reference(spmv_format, dtype):
    a = laplace_2d(13, 11)
    jp = j_build_plan(a, method="hbmc", spmv_format=spmv_format,
                      dtype=jnp.float64 if dtype == torch.float64
                      else jnp.float32)
    plan = build_plan(a, method="hbmc", spmv_format=spmv_format,
                      dtype=dtype, device="cpu")
    want = j_traffic_report(jp, measure=False)
    got = traffic_report(plan, measure=False)
    assert [(t.name, t.static_bytes, t.detail) for t in got.terms] == \
        [(t.name, t.static_bytes, t.detail) for t in want.terms]
    assert got.iteration_bytes == want.iteration_bytes
    assert got.iteration_flops == want.iteration_flops
    assert got.arithmetic_intensity == want.arithmetic_intensity


@pytest.mark.parametrize("spmv_format", ["sell", "ell"])
def test_kernel_terms_match_the_wrappers(spmv_format):
    plan = build_plan(laplace_2d(13, 11), method="hbmc",
                      spmv_format=spmv_format, **PLAN)
    rep = traffic_report(plan)
    names = [t.name for t in rep.kernel_terms]
    assert names == (["kernel/apply", "kernel/spmv"]
                     if spmv_format == "sell" else ["kernel/apply"])
    for term in rep.kernel_terms:
        assert term.measured_bytes == term.static_bytes > 0
    assert check_plan_traffic(plan) == []


class _Twice:
    """An apply that launches its kernel twice."""

    def __init__(self, pre):
        self.tables = pre.tables
        self._pre = pre

    def __call__(self, r):
        self._pre(r)
        return self._pre(r)


class _Padded:
    """An apply that hands the kernel its tables padded by one entry a
    row (a hole, value 0): the same result from more bytes."""

    def __init__(self, pre):
        t = self.tables = pre.tables
        m = t.n_steps * t.lanes
        self._cols = torch.nn.functional.pad(t.cols, (0, 1), value=m)
        self._vals = torch.nn.functional.pad(t.vals, (0, 1))

    def __call__(self, r):
        t = self.tables
        return hbmc_trisolve_fused(self._cols, self._vals, t.dinv,
                                   r.reshape(t.n_steps, t.lanes))


@pytest.mark.parametrize("doctor", [_Twice, _Padded])
def test_traffic_check_names_the_doctored_apply(doctor):
    plan = build_plan(laplace_2d(13, 11), method="hbmc", **PLAN)
    plan._precond = doctor(plan._precond)
    vio = check_plan_traffic(plan)
    assert [v.kind for v in vio] == ["traffic-model-mismatch"]
    assert "term kernel/apply" in vio[0].detail


def test_traffic_inflation_is_pinned_to_term():
    plan = build_plan(laplace_2d(13, 11), method="hbmc", **PLAN)
    rep = traffic_report(plan)
    doctored = tuple(
        dataclasses.replace(t, static_bytes=t.static_bytes * 1.3)
        if t.name == "kernel/apply" else t for t in rep.kernel_terms)
    vio = compare_traffic(rep.terms + doctored)
    assert [v.kind for v in vio] == ["traffic-model-mismatch"]
    assert "term kernel/apply" in vio[0].detail


def test_traffic_requires_round_major():
    plan = build_plan(laplace_2d(9, 8), method="mc", layout="index", **PLAN)
    with pytest.raises(ValueError, match="round_major"):
        traffic_report(plan)


def _snapshot(name="BENCH_trisolve.json"):
    return json.loads((BENCH_DIR / name).read_text())


def _doctor(kind):
    base = _snapshot()
    cand = copy.deepcopy(base)
    if kind == "regression":
        cand["results"][0]["apply_us"] *= 3.0
    elif kind == "iterations":
        cand["results"][0]["iterations"] += 10
    elif kind == "schema-drift":
        del cand["results"][0]["solve_us"]
    elif kind == "throughput-ok":
        base = {"schema": "t/v1", "rhs_per_s": 100.0}
        cand = {"schema": "t/v1", "rhs_per_s": 90.0}
    elif kind == "throughput-drop":
        base = {"schema": "t/v1", "rhs_per_s": 100.0}
        cand = {"schema": "t/v1", "rhs_per_s": 50.0}
    elif kind == "vacuous":
        base = cand = {"foo": 1}
    return base, cand


@pytest.mark.parametrize(
    "snapshot", sorted(p.name for p in BENCH_DIR.glob("BENCH_*.json")))
def test_bench_gate_self_passes_on_every_snapshot(snapshot):
    doc = _snapshot(snapshot)
    assert bench_gate(doc, doc) == j_analysis.bench_gate(doc, doc) == []


@pytest.mark.parametrize("kind", ["regression", "iterations", "schema-drift",
                                  "throughput-ok", "throughput-drop",
                                  "vacuous"])
def test_bench_gate_gives_the_reference_verdicts(kind):
    base, cand = _doctor(kind)
    got = bench_gate(base, cand)
    assert _rows(got) == _rows(j_analysis.bench_gate(base, cand))
    assert bool(got) == (kind != "throughput-ok")


def test_bench_gate_cli_smoke_and_doctored(tmp_path, capsys):
    rc = analysis_main(["bench-gate", "--smoke",
                        "--baseline-dir", str(BENCH_DIR)])
    out = capsys.readouterr().out
    assert rc == 0 and "gate(s) passed" in out
    cand = _snapshot()
    cand["results"][0]["apply_us"] *= 3.0
    cpath = tmp_path / "cand.json"
    cpath.write_text(json.dumps(cand))
    wpath = tmp_path / "witness.json"
    rc = analysis_main(["bench-gate", "--baseline-dir", str(BENCH_DIR),
                        "--candidate", str(cpath),
                        "--witness-json", str(wpath)])
    capsys.readouterr()
    assert rc == 1
    assert any("apply_us" in w["detail"]
               for w in json.loads(wpath.read_text()))


# ---------------------------------------------------------------------------
# 5. Linters over the dispatch stream: op budgets, dtype flow, collectives.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plans():
    a = laplace_2d(13, 11)
    return {layout: build_plan(a, method="hbmc", layout=layout, **PLAN)
            for layout in LAYOUTS}


def _iteration(plan, precond=None):
    step = pcg_iteration(plan._spmv, precond or plan._precond)
    b = nonzero_rhs(plan)
    return step, (torch.zeros_like(b), b, b.clone(),
                  torch.ones((), dtype=plan.dtype))


def test_kernels_are_opaque_nodes(plans):
    """On the CPU the apply's kernel runs its plain version, which gathers
    (``aten.index``) op by op; the linter sees one kernel node instead."""
    plan = plans["round_major"]
    counts = primitive_counts(plan._precond, nonzero_rhs(plan))
    assert counts["kernel.hbmc_trisolve_fused"] == 1
    assert counts["kernel"] == 1
    assert not any(n.startswith("aten.index") for n in counts)
    counts = primitive_counts(plan._spmv, nonzero_rhs(plan))
    assert counts["kernel.sell_spmv"] == 1 and counts["kernel"] == 1


def test_round_major_iteration_budgets_hold(plans):
    plan = plans["round_major"]
    steps = 2 * plan.n_rounds
    assert lint(plan._precond, nonzero_rhs(plan), budget=ROUND_MAJOR_APPLY) == []
    assert lint(plan._spmv, nonzero_rhs(plan), budget=PALLAS_SPMV) == []
    step, args = _iteration(plan)
    assert lint(step, *args, budget=FULL_PALLAS_ITERATION, steps=steps) == []
    assert lint(step, *args, budget=PRECONDITIONED_ITERATION,
                steps=steps) == []


def test_index_iteration_runs_two_sweeps_and_scatters(plans):
    """The index apply is two sweep kernels between permutations, which
    are scatters (``index_copy_``) outside the kernels: both sweeps, and
    no all-kernel iteration."""
    plan = plans["index"]
    step, args = _iteration(plan)
    assert lint(step, *args, budget=PRECONDITIONED_ITERATION) == []
    found = lint(step, *args, budget=FULL_PALLAS_ITERATION)
    assert found and "aten.index_copy_" in found[0]


def test_doctored_apply_with_a_scatter_is_named(plans):
    plan = plans["round_major"]
    pre = plan._precond

    def leaky(q):
        z = pre(q)
        z[torch.tensor([0])] = 0.0
        return z

    found = lint(leaky, nonzero_rhs(plan), budget=ROUND_MAJOR_APPLY)
    assert len(found) == 1 and "aten.index_put_" in found[0]
    with pytest.raises(ContractError, match="index_put_"):
        assert_budget(leaky, nonzero_rhs(plan), budget=ROUND_MAJOR_APPLY,
                      context="apply")


@pytest.mark.parametrize("doctor,sweeps", [("twice", 4), ("plain-cg", 0)])
def test_preconditioned_iteration_counts_the_sweeps(plans, doctor, sweeps):
    plan = plans["round_major"]
    pre = plan._precond
    precond = (lambda r: pre(pre(r))) if doctor == "twice" else \
        (lambda r: r.clone())
    step, args = _iteration(plan, precond)
    found = lint(step, *args, budget=PRECONDITIONED_ITERATION,
                 steps=2 * plan.n_rounds)
    assert found == [f"[preconditioned-iteration] expected 2 triangular "
                     f"sweeps in the kernels, found {sweeps}"]


def test_lint_flags_forbidden_required_and_exact():
    gatherful = lambda x: x[torch.tensor([0, 2, 1])]        # noqa: E731
    v = torch.arange(4.0, dtype=torch.float64)
    findings = lint(gatherful, v, budget=PALLAS_SPMV)
    assert any("aten.index" in f for f in findings)
    assert any("'kernel'" in f for f in findings)           # required
    with pytest.raises(ContractError, match="aten.index"):
        assert_budget(gatherful, v, budget=PALLAS_SPMV, context="spmv")
    exact = PrimitiveBudget(name="exact", exact=(("aten.sin", 2),))
    assert lint(torch.sin, v, budget=exact) != []
    assert lint(lambda x: torch.sin(torch.sin(x)), v, budget=exact) == []


def test_ell_spmv_is_not_a_kernel_spmv():
    plan = build_plan(laplace_2d(9, 8), method="hbmc", spmv_format="ell",
                      **PLAN)
    found = lint(plan._spmv, nonzero_rhs(plan), budget=PALLAS_SPMV)
    assert any("aten.index" in f for f in found)
    assert any("'kernel' absent" in f for f in found)


def test_refactor_captures_nothing(plans):
    plan = plans["round_major"]
    a = laplace_2d(13, 11)
    plan.solve(np.ones(a.shape[0]))
    a2 = (a + 0.37 * sp.diags(a.diagonal())).tocsr()
    assert recaptures(plan, lambda: plan.refactor(a2)) == 0
    assert recaptures(plan, lambda: plan.solve(np.ones(a.shape[0]))) == 0
    plan.refactor(a)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_dtype_flow_proves_clean(layout, dtype):
    """Python scalars (the counterpart of JAX's weak types) entering an f32
    plan are no demotion."""
    plan = build_plan(laplace_2d(13, 11), method="hbmc", layout=layout,
                      dtype=dtype, **PLAN)
    assert contract_for_plan(plan).vector == str(dtype)[len("torch."):]
    assert check_plan_dtype_flow(plan) == []


def test_injected_demotion_is_named(plans):
    plan = plans["round_major"]
    contract = contract_for_plan(plan)
    pre = plan._precond
    leaky = lambda q: pre(q.to(torch.float32).to(torch.float64))  # noqa: E731
    vio = lint_dtype_flow(leaky, nonzero_rhs(plan), contract=contract,
                          where="mutated")
    demo = [v for v in vio if v.kind == "silent-demotion"]
    assert demo, _rows(vio)
    assert "aten._to_copy" in demo[0].detail
    assert "float64 -> float32" in demo[0].detail
    assert any(v.kind == "silent-promotion" for v in vio)
    allow = dataclasses.replace(
        contract, allowed_converts=(("float64", "float32"),
                                    ("float32", "float64")))
    assert lint_dtype_flow(leaky, nonzero_rhs(plan), contract=allow) == []


def test_f32_scalar_tensor_in_an_f64_step_is_named(plans):
    """``torch.tensor(1.0)`` is made in float32: put into the f64 step it
    is a stray dtype, named by its op, though the product stays f64."""
    plan = plans["round_major"]
    pre = plan._precond
    step, args = _iteration(plan, lambda r: pre(r) * torch.tensor(1.0))
    vio = lint_dtype_flow(step, *args, contract=contract_for_plan(plan))
    # the tensor's creation, then the product that reads it
    assert [v.kind for v in vio] == ["stray-dtype"] * 2
    assert "aten.lift_fresh" in vio[0].detail and "float32" in vio[0].detail
    assert "aten.mul" in vio[1].detail


def test_wrong_accumulator_and_stray_dtypes_are_witnessed():
    contract = PrecisionContract(name="f64", vector="float64",
                                 accum="float64", tables="float64")
    x = torch.zeros(8, dtype=torch.float32)
    vio = lint_dtype_flow(lambda v: torch.dot(v, v), x, contract=contract)
    assert any(v.kind == "accum-dtype" and "aten.dot" in v.detail
               for v in vio)
    x16 = torch.zeros(8, dtype=torch.float16)
    vio = lint_dtype_flow(torch.sin, x16, contract=contract)
    assert any(v.kind == "stray-dtype" and "float16" in v.detail
               for v in vio)


def test_deep_admission_rejects_contract_breaker(plans):
    plan = plans["round_major"]
    bad = PrecisionContract(name="impossible", vector="float32",
                            accum="float32", tables="float32")
    vio = check_plan_dtype_flow(plan, contract=bad)
    assert vio and all(v.kind in ("stray-dtype", "accum-dtype",
                                  "silent-demotion", "silent-promotion")
                       for v in vio)
    with pytest.raises(ScheduleError):
        assert_plan_dtype_flow(plan, contract=bad, context="impossible")


def test_validate_deep_gates_build_and_cache():
    a = laplace_2d(9, 8)
    plan = build_plan(a, method="hbmc", validate="deep", **PLAN)
    assert validate_plan(plan, "deep") == []
    cache = PlanCache(capacity=1, validate="deep")
    _, status = cache.get(a, method="hbmc", **PLAN)
    assert status == "miss" and len(cache) == 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_single_device_plan_issues_no_collective(plans, layout):
    assert check_plan_collectives(plans[layout]) == []


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo group and its ``("data",)`` mesh, destroyed at the
    module's end."""
    assert not dist.is_initialized(), "a process group leaked in"
    store = tmp_path_factory.mktemp("mesh1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_mesh_plan_proves_its_collectives(mesh1):
    a = laplace_2d(13, 11)
    plan = build_plan(a, method="hbmc", mesh=mesh1, lane_multiple=2,
                      validate="deep", block_size=8, w=4)
    assert check_plan_collectives(plan) == []
    assert check_plan_kernels(plan) == check_plan_kernels(plan, 8) == []
    steps = 2 * plan.n_rounds
    assert lint(plan._precond, nonzero_rhs(plan), budget=DISTRIBUTED_APPLY,
                steps=steps) == []
    step, args = _iteration(plan)
    assert lint(step, *args, budget=PRECONDITIONED_ITERATION,
                steps=steps) == []
    twice = lambda q: plan._precond(plan._precond(q))        # noqa: E731
    found = lint(twice, nonzero_rhs(plan), budget=DISTRIBUTED_APPLY, steps=steps)
    assert found and f"found {2 * steps}" in found[0]
    # a built mesh plan keeps only its lane block: "full" and "deep"
    # gather the ranks' blocks and prove the whole tables
    assert [validate_plan(plan, m) for m in ("cheap", "full", "deep")] == \
        [[], [], []]


def test_built_mesh_plan_validates_as_the_single_device_plan(mesh1):
    """``validate_plan`` on a built mesh plan returns the reference's
    verdict (``[]``, as the reference's on its one-device mesh plan) in
    every mode, and on a doctored block the single-device plan's witnesses
    on the same doctored table; once the group is gone it raises."""
    import _torch_mesh_worker as worker
    a, _, _ = worker.system()
    plan = build_plan(a, method="hbmc", mesh=mesh1, **worker.PLAN)
    single = build_plan(a, method="hbmc", device="cpu", **worker.PLAN)
    modes = ("cheap", "full", "deep")
    assert [validate_plan(plan, m) for m in modes] == [[], [], []]
    jp = j_build_plan(a, method="hbmc", mesh=jax.make_mesh((1,), ("data",)),
                      **worker.PLAN)
    assert [j_validate_plan(jp, m) for m in modes] == [[], [], []]
    pos = worker.doctor(plan._precond.tables, 0, plan._precond.lanes)
    worker.doctor(single._precond.tables, 0, plan._precond.lanes)
    want = validate_plan(single, "full")
    assert any(v.kind == "premature-read" and v.edge == (pos, pos)
               for v in want), _rows(want)
    assert validate_plan(plan, "full") == want


def test_doctored_collectives_are_named(mesh1):
    x = torch.ones(4, dtype=torch.float64)

    def reducing(v):
        dist.all_reduce(v)
        return v

    vio = check_collectives(reducing, x)
    assert [v.kind for v in vio] == ["forbidden-collective"]
    assert "allreduce" in vio[0].detail
    vio = check_collectives(lambda v: v * 2.0, x, trisolve=3)
    assert [v.kind for v in vio] == ["missing-collective"]


def test_shard_block_must_be_the_ranks_slice(mesh1):
    plan = build_plan(laplace_2d(13, 11), method="hbmc", lane_multiple=2,
                      block_size=8, w=4, device="cpu")
    whole = plan._precond.tables
    assert check_shard_block(whole, whole, mesh1, "data") == []
    other = dataclasses.replace(whole, dinv=whole.dinv.flip(1))
    vio = check_shard_block(whole, other, mesh1, "data")
    assert [v.kind for v in vio] == ["shard-mismatch"]
    assert "dinv" in vio[0].detail


# ---------------------------------------------------------------------------
# 6. The command line, and the port's imports.
# ---------------------------------------------------------------------------

def test_analysis_cli_clean_run_exits_zero(capsys):
    rc = analysis_main(["--device", "cpu", "--problems",
                        "laplace2d,thermal2", "--methods", "hbmc,mc",
                        "--scale", "tiny", "--contracts"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "all 4 audits clean" in out


def test_audit_cli_runs_new_linters(capsys):
    rc = analysis_main(["--device", "cpu", "--problems", "laplace2d",
                        "--methods", "hbmc", "--validate", "deep",
                        "--dtype-flow", "--traffic", "--collectives"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "all 1 audits clean" in out


def test_analysis_cli_tampered_run_exits_one(monkeypatch, tmp_path,
                                             capsys):
    import repro_torch.core as core
    real = core.build_plan

    def sabotaged(a, **knobs):
        plan = real(a, **knobs)
        j, i = _dependent_pair(plan._sysd)
        _swap_rows_in_place(plan._sysd.fwd_rounds, i, j)
        _swap_rows_in_place(plan._sysd.bwd_rounds, i, j)
        return plan

    monkeypatch.setattr(core, "build_plan", sabotaged)
    wpath = tmp_path / "witness.json"
    rc = analysis_main(["--device", "cpu", "--problems", "laplace2d",
                        "--methods", "mc", "--witness-json", str(wpath)])
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL" in out
    assert any(w["kind"] == "cross-round-order"
               for w in json.loads(wpath.read_text()))


def test_analysis_cli_refuses_jax_knobs_and_a_missing_card(monkeypatch):
    with pytest.raises(SystemExit) as exc:
        analysis_main(["--device", "cpu", "--backend", "xla"])
    assert exc.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis_main(["--problems", "laplace2d"])


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port, the analysis package included, and
    ``chip_smoke.py``: no ``jax``, nothing of ``repro``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert any(f.parent.name == "analysis" for f in files)
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.__main__;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"
