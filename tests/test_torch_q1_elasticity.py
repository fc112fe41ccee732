"""The audikw_1 configuration's matrix family and what it brought to the
port, on the CPU.

* The generator (``portbench/matrices/fem3d_q1_elasticity.py``): Q1-brick
  elasticity with one clamped face is symmetric, definite, has n =
  3 M (M + 1)^2 and 81-entry rows inside, and its brick stiffness has
  exactly the six rigid-body modes as its null space.
* The port's plan with the cell's knobs against the plain reference
  (``portbench/reference/iccg_plain.py``) in the plan's ordering: one
  apply, the f64 iteration counts and statuses, the solutions.
* The port's host tables bitwise the JAX reference's on the generator's
  matrix.
* Stored zeros: an assembled matrix that stores exact zeros builds (the
  reference raises on it), and its plan is bitwise the plan of the same
  matrix with the zeros dropped by the caller.
* The segment analysis's record (``segments.analysed()``), the launch
  paths of ``kernels.forwarding_counts()`` and the ``b1_step_us.solve``
  reader over them.
"""
import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core.plan as j_plan
from repro.core import build_plan as j_build_plan
from repro.core.ic0 import ic0_refactor as j_ic0_refactor
from repro.core.ic0 import ic0_structure as j_ic0_structure
import repro_torch.core.plan as t_plan
from repro_torch import kernels
from repro_torch.core import build_plan
from repro_torch.core.ic0 import ic0_refactor as t_ic0_refactor
from repro_torch.core.ic0 import ic0_structure as t_ic0_structure
from repro_torch.kernels import segments

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import spec  # noqa: E402
from portbench.lib.harness import Request, Run  # noqa: E402
from portbench.lib.trace import DeviceTrace  # noqa: E402
from portbench.reference import iccg_plain  # noqa: E402

gen = spec.load_module("matrices", "fem3d_q1_elasticity")
#: the module (the package's name ``hbmc_trisolve`` is the wrapper)
trisolve_mod = importlib.import_module("repro_torch.kernels.hbmc_trisolve")

#: the audikw_1 cell's plan knobs
CELL = dict(method="hbmc", block_size=16, w=8, spmv_format="sell",
            layout="round_major", dtype=torch.float64)


def q1(m: int, sigma: float = 1.0) -> sp.csr_matrix:
    return gen.make({"m": m, "nu": 0.3, "sigma": sigma},
                    np.random.default_rng(0))


def _stored_rows(m: int) -> np.ndarray:
    """Stored entries of each row, counted from the mesh: a node couples
    to the nodes of its bricks, those on the clamped face left out."""
    p = m + 1
    edge = np.array([2] + [3] * (m - 1) + [2])            # i or j: 0..m
    zed = np.array([2] + [3] * (m - 2) + [2]) if m > 1 else np.array([1])
    per_node = 3 * (zed[:, None, None] * edge[None, :, None]
                    * edge[None, None, :])                # [k-1, j, i]
    assert per_node.shape == (m, p, p)
    return np.repeat(per_node.ravel(), 3)


# -- the generator -----------------------------------------------------------

@pytest.mark.parametrize("sigma", [1.0, 0.0])
@pytest.mark.parametrize("m", [2, 3, 6])
def test_generator_size_symmetry_and_rows(m, sigma):
    a = q1(m, sigma)
    n = 3 * m * (m + 1) ** 2
    assert a.shape == (n, n)
    # exactly symmetric, stored pattern and values
    diff = a - a.T
    assert diff.nnz == 0 or np.abs(diff.data).max() == 0.0
    np.testing.assert_array_equal(np.diff(a.indptr), _stored_rows(m))
    assert np.diff(a.indptr).max() == (81 if m > 2 else 54)
    zeros = int((a.data == 0).sum())
    # a varying modulus cancels no entry; one material cancels many
    assert (zeros == 0) == (sigma != 0.0)


@pytest.mark.parametrize("sigma", [1.0, 0.0])
def test_generator_positive_definite(sigma):
    a = q1(3, sigma).toarray()
    np.linalg.cholesky(a)               # raises LinAlgError if not SPD
    assert np.all(np.diag(a) > 0)


def test_interior_rows_hold_81_nonzeros_at_m6():
    a = q1(6)
    m, p = 6, 7
    k, j, i = np.meshgrid(np.arange(1, m + 1), np.arange(p), np.arange(p),
                          indexing="ij")
    inside = ((k > 1) & (k < m) & (i > 0) & (i < m) & (j > 0) & (j < m))
    rows = np.repeat(inside.ravel(), 3)
    nonzero = np.add.reduceat(a.data != 0, a.indptr[:-1])
    assert rows.sum() == 3 * 4 * 5 * 5
    assert np.all(nonzero[rows] == 81)


@pytest.mark.parametrize("nu", [0.3, 0.0, 0.45])
def test_brick_stiffness_null_space_is_the_rigid_body_modes(nu):
    k0 = gen.brick_stiffness(nu)
    np.testing.assert_array_equal(k0, k0.T)
    ev = np.linalg.eigvalsh(k0)
    tol = 1e-12 * ev[-1]
    assert int((np.abs(ev) < tol).sum()) == 6
    assert ev[6] > 1e-3 * ev[-1]
    # three translations and three rotations about the brick's centre
    xyz = gen.CORNERS - 0.5
    modes = []
    for c in range(3):
        t = np.zeros((8, 3))
        t[:, c] = 1.0
        modes.append(t.ravel())
    for axis in np.eye(3):
        modes.append(np.cross(axis, xyz).ravel())
    np.testing.assert_allclose(k0 @ np.array(modes).T, 0.0,
                               atol=1e-13 * ev[-1])


# -- the port against the plain reference ------------------------------------

@functools.cache
def _pair(m: int):
    """(a, the port's plan with the cell's knobs, the plain reference's
    factor in the plan's ordering, a right-hand side)."""
    a = q1(m)
    plan = build_plan(a, device="cpu", **CELL)
    factor = iccg_plain.ic0(a, plan._perm)
    b = np.random.default_rng(100 + m).normal(size=a.shape[0])
    return a, plan, factor, b


@pytest.mark.parametrize("m", [4, 6])
def test_one_apply_matches_the_plain_reference(m):
    _, plan, factor, b = _pair(m)
    z = plan.extract_solution(plan._precond(plan.embed_rhs(b)))
    want = iccg_plain.apply(factor, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(z - want) <= 1e-12 * np.linalg.norm(want)


@pytest.mark.parametrize("m", [4, 6])
def test_solve_matches_the_plain_reference(m):
    a, plan, factor, b = _pair(m)
    rep = plan.solve(b, rtol=1e-7)
    want = iccg_plain.pcg(a, b, factor, rtol=1e-7)
    assert want.status == "CONVERGED"
    assert (rep.result.iterations, rep.result.status) == (want.iterations,
                                                          want.status)
    assert np.linalg.norm(rep.x - want.x) <= 1e-10 * np.linalg.norm(want.x)
    assert plan.clamped_pivots == 0


# -- the port's host tables against the JAX reference ------------------------

def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _csr_eq(a, b, what):
    for f in ("indptr", "indices", "data"):
        _eq(getattr(a, f), getattr(b, f), f"{what}.{f}")


def test_setup_pipeline_bitwise_the_reference():
    """Ordering, rounds and IC(0) factor at M = 4 with the cell's block
    and w, bitwise the reference's."""
    a = q1(4)
    a.sort_indices()
    sj = j_plan._order_system(a, None, "hbmc", 16, 8)
    st = t_plan._order_system(a, None, "hbmc", 16, 8)
    _eq(sj.perm, st.perm, "perm")
    _csr_eq(sj.a_bar, st.a_bar, "a_bar")
    assert len(sj.fwd_rounds) == len(st.fwd_rounds)
    for x, y in zip(sj.fwd_rounds, st.fwd_rounds):
        _eq(x, y, "fwd_rounds")
    lj = j_ic0_refactor(j_ic0_structure(sj.a_bar, sj.fwd_rounds), sj.a_bar)
    lt = t_ic0_refactor(t_ic0_structure(st.a_bar, st.fwd_rounds), st.a_bar)
    _csr_eq(lj, lt, "L")
    assert lj.clamped_pivots == lt.clamped_pivots == 0


def test_plan_operands_bitwise_the_reference():
    """The fused tables and the SELL operand the plans upload, at M = 4
    with the cell's knobs, bitwise the reference's."""
    a = q1(4)
    kw = dict(method="hbmc", block_size=16, w=8)
    jp = j_build_plan(a, spmv_format="sell", **kw)
    tp = build_plan(a, device="cpu", **kw)
    jt, tt = jp._precond.tables, tp._precond.tables
    assert tuple(tt.cols.shape)[2] == 80
    for f in ("cols", "vals", "dinv"):
        _eq(np.asarray(getattr(jt, f)), getattr(tt, f).numpy(), f)
    _eq(np.asarray(jp._spmv_vals), tp._spmv_vals.numpy(), "sell vals")
    _eq(np.asarray(jp._spmv_cols), tp._spmv_cols.numpy(), "sell cols")
    assert (jp.n, jp.n_padded, jp.n_rounds) == (tp.n, tp.n_padded,
                                                tp.n_rounds)


# -- stored zeros ------------------------------------------------------------

#: one material at M = 10: 39,528 of 242,172 stored entries are exact
#: zeros; block 8, w 4 puts two rows joined only by a stored zero in one
#: round, so the reference's IC(0) structure raises
ZEROS = dict(m=10, block_size=8, w=4)


def test_stored_zeros_raise_in_the_reference():
    a = q1(ZEROS["m"], 0.0)
    assert int((a.data == 0).sum()) == 39_528
    kw = dict(method="hbmc", block_size=ZEROS["block_size"], w=ZEROS["w"])
    with pytest.raises(ValueError, match="dependency-ordered"):
        j_build_plan(a, **kw)
    # the same set-up steps in the port, without the plan's repair
    st = t_plan._order_system(a, None, "hbmc", ZEROS["block_size"],
                              ZEROS["w"])
    with pytest.raises(ValueError, match="dependency-ordered"):
        t_ic0_structure(st.a_bar, st.fwd_rounds)


def test_stored_zeros_plan_builds_and_converges():
    a = q1(ZEROS["m"], 0.0)
    stored = a.nnz
    plan = build_plan(a, device="cpu", method="hbmc",
                      block_size=ZEROS["block_size"], w=ZEROS["w"])
    assert a.nnz == stored and int((a.data == 0).sum()) == 39_528
    rep = plan.solve(np.random.default_rng(7).normal(size=a.shape[0]))
    assert rep.result.status == "CONVERGED"
    assert plan.clamped_pivots == 0


def _same_plan(p, q):
    for f in ("cols", "vals", "dinv"):
        assert torch.equal(getattr(p._precond.tables, f),
                           getattr(q._precond.tables, f)), f
    assert torch.equal(p._spmv_vals, q._spmv_vals)
    assert torch.equal(p._spmv_cols, q._spmv_cols)
    _eq(p._perm, q._perm, "perm")


@pytest.mark.parametrize("knobs", [(8, 4), (16, 8)], ids=["b8w4", "cell"])
def test_stored_zeros_plan_bitwise_the_dropped_matrix(knobs):
    a = q1(ZEROS["m"], 0.0)
    dropped = a.copy()
    dropped.eliminate_zeros()
    kw = dict(device="cpu", method="hbmc", block_size=knobs[0], w=knobs[1])
    plan, want = build_plan(a, **kw), build_plan(dropped, **kw)
    _same_plan(plan, want)
    # refactor takes the stored pattern, zeros where they were dropped
    a2, d2 = a.copy(), dropped.copy()
    a2.data *= 2.0
    d2.data *= 2.0
    plan.refactor(a2)
    want.refactor(d2)
    _same_plan(plan, want)
    bad = a.copy()
    bad.data[bad.data == 0] = 1.0
    with pytest.raises(ValueError, match="stored zeros"):
        plan.refactor(bad)


def test_matrix_without_stored_zeros_keeps_its_plan():
    a = q1(4)
    plan = build_plan(a, device="cpu", **CELL)
    assert plan._kept is None
    _same_plan(plan, build_plan(a.copy(), device="cpu", **CELL))


# -- the segment analysis's record and the launch paths ----------------------

def test_analysed_records_the_cell_plans_table():
    _, plan, _, b = _pair(4)
    kernels.reset_launch_counts()
    assert segments.analysed() == []
    t = plan._precond.tables
    t.__dict__.pop("segments", None)          # analysed again at next use
    plan._precond(plan.embed_rhs(b))
    got = segments.analysed()
    assert got == [segments.Analysed(True, t.n_steps * 2, t.lanes, 80,
                                     int(t.segments.size))]
    assert got[0].steps == 2 * plan.n_rounds and got[0].segments >= 2
    kernels.reset_launch_counts()
    assert segments.analysed() == []


@pytest.mark.parametrize("k", [6, 8, 9, 80])
@pytest.mark.parametrize("fused", [True, False], ids=["B1", "B5"])
def test_forwarding_counts_follow_the_paths_passed(monkeypatch, fused, k):
    """The wrappers' accounting of B1 / B5's launches, with the launch
    replaced: the wrapper passes ``segments.single_paths``' code for each
    segment, and counts each launch under its code's path.  A cut of 1, 2
    and 3+ steps: on chip from 3 steps where K <= ON_CHIP_MAX_K; every
    launch on lane groups where ``segments.lane_group(K, R)`` > 1 (3
    lanes: 8 threads at K = 9, 32 at 80); plain where no group fits (at
    70,000 lanes)."""
    s = 6
    n_steps = 2 * s if fused else s
    cut = np.array([0, 1, 3], dtype=np.int32)
    monkeypatch.setattr(trisolve_mod, "runs_plain", lambda t: False)
    monkeypatch.setattr(trisolve_mod, "_check", lambda *t: None)
    name = "hbmc_trisolve_fused" if fused else "hbmc_trisolve"
    want_codes = {(6, 3): [0, 0, 1], (8, 3): [0, 0, 1], (9, 3): [8] * 3,
                  (80, 3): [32] * 3}
    for r in (3, 70_000):
        want = want_codes.get((k, r), [0, 0, 1] if k <= 8 else [0, 0, 0])
        # the checks and the launch are replaced, so the operands need
        # only their shapes
        cols = torch.zeros((1, 1, 1), dtype=torch.int32).expand(n_steps, r,
                                                                k)
        vals = torch.zeros((1, 1, 1), dtype=torch.float64).expand(n_steps,
                                                                  r, k)
        dinv = torch.ones((n_steps, r), dtype=torch.float64)
        q = torch.zeros((s, r), dtype=torch.float64)
        passed = []

        def entry(name_, cols, vals, dinv, q, seg, paths):
            assert name_ == name and seg.tolist() == cut.tolist()
            passed.append(paths.tolist())
            return torch.zeros(s * r, dtype=torch.float64), seg.size

        monkeypatch.setattr(trisolve_mod, "_run", entry)
        kernels.reset_launch_counts()
        fn = (kernels.hbmc_trisolve_fused if fused
              else kernels.hbmc_trisolve)
        fn(cols, vals, dinv, q, segments=cut)
        assert passed == [want] == [
            segments.single_paths(k, r, s, cut, fused).tolist()], r
        codes = np.array(want)
        assert kernels.forwarding_counts()[name] == {
            "on_chip": int((codes == 1).sum()),
            "plain": int((codes == 0).sum()),
            "grouped": int((codes > 1).sum())}, r
        assert sum(kernels.forwarding_counts()[name].values()) == \
            kernels.cuda_launch_counts()[name] == 3
    kernels.reset_launch_counts()


# -- the b1_step_us.solve reader ---------------------------------------------

B1_READER = spec.load_module("metrics", "b1_step_us.solve")


def _traced_run(records) -> Run:
    run = Run(workload="audikw_1.solve", config={}, traffic={}, seed=0,
              seconds=1.0, traced=True, device=torch.device("cpu"),
              t_process=0.0)
    run.device_trace = DeviceTrace(window=(0.0, 1e6), device=records,
                                   host_ranges=[], host_ops=[])
    run.requests = [Request(0, 0.0, 1.0, 9, "CONVERGED")]
    return run


#: 2 applies of a table of 480 steps in 3 launches: 6 launches, 2,880 us
B1_RECORDS = [(1000.0 * i, 1000.0 * i + 480.0,
               "void (anonymous namespace)::segment_single<double, true, "
               "0, int>()") for i in range(6)]
OTHER = [(9000.0, 9100.0, "void sell_spmv_kernel<double>()")]


def test_b1_step_us_reads_time_over_applies_and_steps(monkeypatch):
    monkeypatch.setattr(segments, "_ANALYSED", [
        segments.Analysed(True, 480, 2117, 80, 3),
        segments.Analysed(False, 240, 2117, 80, 5)])
    run = _traced_run(B1_RECORDS + OTHER)
    assert B1_READER.read(run) == pytest.approx(6 * 480.0 / (2 * 480))


@pytest.mark.parametrize("case", ["no_record", "two_shapes", "no_fused",
                                  "no_trace", "no_b1"])
def test_b1_step_us_reads_none(monkeypatch, case):
    one = segments.Analysed(True, 480, 2117, 80, 3)
    records = {"no_record": [], "two_shapes": [one, one._replace(k=6)],
               "no_fused": [one._replace(fused=False)]}.get(case, [one])
    monkeypatch.setattr(segments, "_ANALYSED", records)
    run = _traced_run(OTHER if case == "no_b1" else B1_RECORDS)
    if case == "no_trace":
        run.device_trace = None
    assert B1_READER.read(run) is None


def test_b1_step_us_reads_none_without_the_programs_record(monkeypatch):
    """A program that keeps no record of its analysed tables (the commit
    before the record) reads None, and nothing raises."""
    monkeypatch.setattr(segments, "_ANALYSED", [
        segments.Analysed(True, 480, 2117, 80, 3)])
    monkeypatch.delattr(segments, "analysed")
    assert B1_READER.read(_traced_run(B1_RECORDS)) is None


def test_tiny_cell_through_the_harness():
    """The cell at M = 3 through the harness, in a process without JAX
    (the harness refuses to report beside it): correct, and set-up
    analysed one fused table of the plan."""
    code = (
        "import json, sys; sys.path[:0] = ['.', 'src']\n"
        "from portbench.lib import harness, spec\n"
        "from repro_torch.kernels import segments\n"
        "cfg = spec.load_json_path('portbench/configs/audikw_1.json')\n"
        "cfg['matrix']['m'] = 3\n"
        "line = harness.run_cell('audikw_1.solve', 2**33 + 7, 0.5, False,"
        " 'cpu', 0.0, config=cfg)\n"
        "print(json.dumps([line['correct'], line['failed'],"
        " sorted(line['metrics']),"
        " [list(r) for r in segments.analysed()]]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    correct, failed, metrics, analysed = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert correct and failed == 0
    assert metrics == ["setup_s", "solve_ms"]
    fused = [r for r in analysed if r[0]]
    assert len(fused) == 1 and fused[0][1] % 2 == 0 and fused[0][4] >= 1
