"""The port's single-RHS solve (SolverPlan + PCG) against the JAX reference.

* ``SolverPlan.from_arrays`` on a JAX plan's packed tables runs the port's
  device path on identical operands: same PCG iteration count and status,
  solution within 1e-9.
* The port's own ``build_plan(device="cpu")`` reproduces the reference's
  MC / BMC / HBMC iteration counts on the five paper generators.
* The health monitor is exact: NaN RHS, zero RHS, non-SPD pairings,
  DIVERGED and STAGNATED end as in the reference.
* ``refactor`` keeps the ``setup_count`` semantics.
* Guards: ``import repro_torch`` loads no JAX and nothing of ``repro``; the
  entry points raise without a CUDA device unless asked for the CPU.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import build_plan as j_build_plan
from repro.core import pcg as j_pcg
from repro.core import solve_iccg as j_solve_iccg
from repro.core.matrices import PAPER_PROBLEMS, PAPER_SHIFTS, laplace_2d
from repro.core.matrices import paper_problem
from repro.serve.faults import indefinite_matrix, near_singular_matrix
from repro_torch.core import SolverPlan, build_plan, pcg, solve_iccg
from repro_torch.kernels import resolve_device

BS, W = 8, 4
ROOT = Path(__file__).resolve().parents[1]


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _jax_plan_arrays(jp):
    """The state of a JAX plan that ``SolverPlan.from_arrays`` takes."""
    t = jp._precond.tables
    return dict(cols=np.asarray(t.cols), vals=np.asarray(t.vals),
                dinv=np.asarray(t.dinv), rows=jp._rm.rows, pos=jp._rm.pos,
                n_slots=jp._rm.n_slots,
                sell_vals=np.asarray(jp._spmv_vals),
                sell_cols=np.asarray(jp._spmv_cols), sell_n=jp._spmv_n,
                perm=jp._sysd.perm, n=jp.n, n_padded=jp.n_padded,
                method=jp.method, n_colors=jp.n_colors)


@pytest.fixture(scope="module")
def pallas_pair():
    """The reference's all-kernel plan (Pallas in interpret mode) on
    laplace_2d(14, 12), and the port's plan over the same tables."""
    a = laplace_2d(14, 12)
    jp = j_build_plan(a, method="hbmc", block_size=BS, w=W,
                      spmv_format="sell", backend="pallas",
                      spmv_backend="pallas", interpret=True)
    return a, jp, SolverPlan.from_arrays(_jax_plan_arrays(jp), device="cpu")


def test_from_arrays_matches_jax_pallas_plan(pallas_pair):
    a, jp, tp = pallas_pair
    b = _rhs(a.shape[0], 1)
    jr, tr = jp.solve(b), tp.solve(b)
    assert tr.result.status == jr.result.status == "CONVERGED"
    assert tr.result.iterations == jr.result.iterations
    np.testing.assert_allclose(tr.x, jr.x, rtol=1e-9, atol=1e-9)
    assert (tr.n, tr.n_padded, tr.n_colors, tr.n_rounds, tr.method) == (
        jr.n, jr.n_padded, jr.n_colors, jr.n_rounds, jr.method)
    assert tr.lane_occupancy == pytest.approx(jr.lane_occupancy)
    assert tr.backend == tr.spmv_backend == "torch"


def test_from_arrays_plan_cannot_refactor(pallas_pair):
    a, _, tp = pallas_pair
    with pytest.raises(ValueError, match="from_arrays"):
        tp.refactor(a)


@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_paper_counts_match_jax(name):
    """The test_paper_semantics settings: bs=8, w=4, PAPER_SHIFTS."""
    a, _ = paper_problem(name, scale="tiny")
    b = np.random.default_rng(7).normal(size=a.shape[0])
    shift = PAPER_SHIFTS.get(name, 0.0)
    for method in ("mc", "bmc", "hbmc"):
        kw = dict(method=method, block_size=BS, w=W, shift=shift)
        jr = j_solve_iccg(a, b, **kw)
        tr = solve_iccg(a, b, device="cpu", **kw)
        assert tr.result.status == jr.result.status == "CONVERGED"
        assert tr.result.iterations == jr.result.iterations, (name, method)
        assert tr.n_rounds == jr.n_rounds
        np.testing.assert_allclose(tr.x, jr.x, rtol=1e-6, atol=1e-6)


def test_levelset_scheduler_count_matches_jax():
    a, _ = paper_problem("g3_circuit", scale="tiny")
    b = _rhs(a.shape[0], 2)
    kw = dict(method="hbmc", block_size=BS, w=W, scheduler="levelset")
    jr = j_solve_iccg(a, b, **kw)
    tr = solve_iccg(a, b, device="cpu", **kw)
    assert tr.scheduler == "levelset"
    assert (tr.n_rounds, tr.result.iterations) == (jr.n_rounds,
                                                   jr.result.iterations)


def test_history_matches_jax():
    a = laplace_2d(9, 7)
    b = _rhs(a.shape[0], 3)
    kw = dict(method="hbmc", block_size=BS, w=W, record_history=True)
    jr = j_solve_iccg(a, b, **kw).result
    tr = solve_iccg(a, b, device="cpu", **kw).result
    assert tr.history.shape == jr.history.shape
    it = tr.iterations
    np.testing.assert_allclose(tr.history[:it + 1], jr.history[:it + 1],
                               rtol=1e-9)
    assert np.isnan(tr.history[it + 1:]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_plan_dtype_is_explicit(dtype):
    a = laplace_2d(8, 8)
    plan = build_plan(a, block_size=BS, w=W, dtype=dtype, device="cpu")
    assert plan._precond.tables.vals.dtype == dtype
    assert plan._spmv_vals.dtype == dtype
    rep = plan.solve(_rhs(a.shape[0]), rtol=1e-5)
    assert rep.result.status == "CONVERGED"
    assert rep.x.dtype == (np.float64 if dtype == torch.float64
                           else np.float32)


# ---------------------------------------------------------------------------
# The health monitor, against the reference on the same operators.
# ---------------------------------------------------------------------------

def _both_pcg(a_dense, b, **kw):
    """Unpreconditioned PCG through both packages on one dense operator."""
    ja = jnp.asarray(a_dense)
    ta = torch.from_numpy(a_dense)
    jr = j_pcg(lambda v: ja @ v, lambda v: v, jnp.asarray(b), **kw)
    tr = pcg(lambda v: ta @ v, lambda v: v, torch.from_numpy(b), **kw)
    return jr, tr


@pytest.mark.parametrize("case", ["diverged", "stagnated", "knobs_off",
                                  "indefinite"])
def test_monitor_matches_jax(case):
    if case == "diverged":
        a_dense = np.diag(np.linspace(1.0, 10.0, 16))
        b, kw = _rhs(16, 4), dict(divergence_factor=1e-6)
    elif case == "indefinite":
        a_dense = np.diag(np.linspace(-3.0, 10.0, 16))
        b, kw = _rhs(16, 5), {}
    else:
        a_dense = near_singular_matrix(6).toarray()
        b = _rhs(36, 7)
        kw = (dict(rtol=1e-14, maxiter=5000, stagnation_window=10)
              if case == "stagnated" else
              dict(rtol=1e-14, maxiter=30, divergence_factor=None,
                   stagnation_window=None))
    jr, tr = _both_pcg(a_dense, b, **kw)
    want = {"diverged": "DIVERGED", "stagnated": "STAGNATED",
            "knobs_off": "MAXITER", "indefinite": "BREAKDOWN"}[case]
    assert tr.status == jr.status == want
    assert tr.iterations == jr.iterations
    assert np.isfinite(tr.x).all()
    if case in ("diverged", "indefinite"):
        # diagonal operators: both packages reduce in the same order up to
        # rounding.  On the near-singular operator the dot products' order
        # drift is amplified by its conditioning, so only the trajectory's
        # length and end are compared there.
        np.testing.assert_allclose(tr.x, np.asarray(jr.x), rtol=1e-9,
                                   atol=1e-9)


def test_nan_rhs_is_breakdown(pallas_pair):
    a, jp, tp = pallas_pair
    b = _rhs(a.shape[0])
    b[5] = np.nan
    for plan in (tp, build_plan(a, block_size=BS, w=W, device="cpu")):
        rep = plan.solve(b)
        assert rep.result.status == "BREAKDOWN"
        assert rep.result.iterations == 0
        assert not rep.result.converged
        assert np.isfinite(rep.x).all()


def test_zero_rhs_converges_at_zero_iterations():
    a = laplace_2d(8, 8)
    plan = build_plan(a, block_size=BS, w=W, device="cpu")
    rep = plan.solve(np.zeros(a.shape[0]))
    assert rep.result.status == "CONVERGED"
    assert rep.result.iterations == 0
    assert rep.result.relres == 0.0
    np.testing.assert_array_equal(rep.x, 0.0)


@pytest.mark.parametrize("method", ["hbmc", "bmc"])
def test_adversarial_matrix_matches_jax(method):
    a = indefinite_matrix(6)
    b = _rhs(a.shape[0])
    kw = dict(method=method, block_size=BS, w=W, maxiter=300)
    jr = j_solve_iccg(a, b, **kw).result
    tr = solve_iccg(a, b, device="cpu", **kw).result
    assert tr.status == jr.status
    assert tr.iterations == jr.iterations
    assert np.isfinite(tr.x).all()


# ---------------------------------------------------------------------------
# refactor / setup_count.
# ---------------------------------------------------------------------------

def test_refactor_keeps_setup_count_semantics():
    a = laplace_2d(10, 9)
    b = _rhs(a.shape[0], 6)
    plan = build_plan(a, block_size=BS, w=W, device="cpu")
    jplan = j_build_plan(a, block_size=BS, w=W, spmv_format="sell")
    assert (plan.setup_count, plan.refactor_count) == (1, 0)
    plan.solve(b)
    plan.solve(b)
    assert (plan.setup_count, plan.refactor_count) == (1, 0)
    a2 = (3.0 * a + sp.identity(a.shape[0])).tocsr()   # same pattern
    br = plan.refactor(a2)
    jplan.refactor(a2)
    assert br.ordering == 0.0 and br.total >= br.factor
    assert (plan.setup_count, plan.refactor_count) == (2, 1)
    rep, jrep = plan.solve(b), jplan.solve(b)
    assert rep.result.iterations == jrep.result.iterations
    res = np.linalg.norm(a2 @ rep.x - b) / np.linalg.norm(b)
    assert res < 1e-6
    assert plan.setup_count == 2


def test_refactor_rejects_new_pattern():
    plan = build_plan(laplace_2d(6, 6), block_size=BS, w=W, device="cpu")
    with pytest.raises(ValueError, match="structure-identical"):
        plan.refactor(laplace_2d(6, 6) @ laplace_2d(6, 6))
    assert plan.setup_count == 1


# ---------------------------------------------------------------------------
# Guards.
# ---------------------------------------------------------------------------

def test_import_loads_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels\n"
            "import repro_torch.serve, repro_torch.kernels.ops\n"
            "import repro_torch.core.smoothers\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = laplace_2d(6, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_plan(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_iccg(a, _rhs(a.shape[0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


def test_resolve_device_rejects_other_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("bad,err,match",
                         [(dict(validate="banana"), ValueError, "validate"),
                          (dict(mesh=object()), TypeError, "DeviceMesh")],
                         ids=["validate", "mesh"])
def test_unported_options_raise(bad, err, match):
    """``validate`` and ``mesh=`` are ported (tests/test_torch_analysis.py,
    tests/test_torch_mesh.py); an unknown validate mode raises naming the
    knob, as in the reference, and ``mesh=`` refuses anything but a
    ``DeviceMesh``."""
    with pytest.raises(err, match=match):
        build_plan(laplace_2d(6, 6), block_size=BS, w=W, device="cpu", **bad)


@pytest.mark.parametrize("bad,match", [(dict(layout="banana"), "layout"),
                                       (dict(spmv_format="csr"),
                                        "spmv_format")],
                         ids=["layout", "spmv_format"])
def test_unknown_layout_or_format_raises(bad, match):
    """As in the reference (tests/test_round_major.py): an unknown layout
    or SpMV format is a ValueError naming the knob."""
    with pytest.raises(ValueError, match=f"unknown {match}"):
        build_plan(laplace_2d(6, 6), block_size=BS, w=W, device="cpu", **bad)


@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_build_round_major_preconditioner_matches_reference(name):
    """``build_round_major_preconditioner`` over an HBMC ordering: its apply
    bitwise the ``_from_rounds`` form on the ordering's rounds, and rel
    1e-12 of the reference's (2-norm, f64) on the same factor."""
    from repro.core.trisolve import \
        build_round_major_preconditioner as j_build
    from repro_torch.core import (build_round_major_preconditioner,
                                  build_round_major_preconditioner_from_rounds,
                                  hbmc_ordering, ic0, pad_system_hbmc,
                                  rounds_hbmc)
    a, _ = paper_problem(name, scale="tiny")
    ordering = hbmc_ordering(a, BS, W)
    a_bar, _ = pad_system_hbmc(a, None, ordering)
    l_bar = ic0(a_bar, shift=PAPER_SHIFTS.get(name, 0.0))
    pre, layout = build_round_major_preconditioner(l_bar, ordering,
                                                   device="cpu")
    pre2, layout2 = build_round_major_preconditioner_from_rounds(
        l_bar, rounds_hbmc(ordering, reverse=False),
        rounds_hbmc(ordering, reverse=True), drop_mask=ordering.is_dummy,
        device="cpu")
    jpre, jlayout = j_build(l_bar, ordering)
    np.testing.assert_array_equal(layout.pos, jlayout.pos)
    np.testing.assert_array_equal(layout.rows, layout2.rows)
    m = pre.tables.n_steps * pre.tables.lanes
    r = _rhs(m, seed=3)
    z = pre(torch.tensor(r))
    assert torch.equal(z, pre2(torch.tensor(r)))
    want = np.asarray(jpre(jnp.asarray(r)))
    assert np.linalg.norm(z.numpy() - want) / np.linalg.norm(want) < 1e-12
