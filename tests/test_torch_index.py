"""The port's index layout (kernels B5/B6, the kernel preconditioner, the
index-space substitution and the ``layout="index"`` plan) against the JAX
reference.

* The single-sweep plain versions (``kernels.ref.hbmc_trisolve_ref`` /
  ``hbmc_trisolve_batched_ref``) on numpy tables from the JAX package,
  against the JAX oracles and the Pallas kernels in interpret mode.
  Tolerance: f64 ``rtol = atol = 1e-12``, f32 ``1e-5`` (JAX sums over K
  with ``jnp.sum``, the port in k order).  Column j of the batched plain
  version is bitwise equal to the single-RHS one on column j.
* ``KernelPreconditioner`` against the reference's and against the
  sequential IC(0) solve; the index apply bitwise equal to the fused
  round-major apply on every live entry.
* ``forward_solve`` / ``backward_solve`` against the reference's; the
  batched forms column by column against the reference's single-RHS
  solves.
* ``solve_iccg(layout="index")`` on the five paper generators (tiny scale,
  SELL and ELL): iteration counts and statuses equal to the reference's
  index layout and to the port's round-major counts; the pinned counts of
  tests/test_paper_semantics.py; the batched, slab, refactor and serving
  paths of an index plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_multicolor_ordering as j_bmc_ordering
from repro.core import build_plan as j_build_plan
from repro.core import hbmc_from_bmc as j_hbmc_from_bmc
from repro.core import ic0 as j_ic0
from repro.core import pack_factor_hbmc as j_pack_factor_hbmc
from repro.core import pad_system_hbmc as j_pad_system_hbmc
from repro.core import sequential_ic_solve
from repro.core import solve_iccg as j_solve_iccg
from repro.core import to_round_major as j_to_round_major
from repro.core.matrices import (PAPER_PROBLEMS, PAPER_SHIFTS,
                                 graph_laplacian, laplace_2d, laplace_3d,
                                 paper_problem)
from repro.core.trisolve import DeviceTables as JDeviceTables
from repro.core.trisolve import backward_solve as j_backward_solve
from repro.core.trisolve import forward_solve as j_forward_solve
from repro.kernels import hbmc_trisolve as j_trisolve
from repro.kernels import hbmc_trisolve_batched as j_trisolve_batched
from repro.kernels.ops import build_kernel_preconditioner as j_build_kp
from repro.kernels.ref import hbmc_trisolve_batched_ref as j_tri_bref
from repro.kernels.ref import hbmc_trisolve_ref as j_tri_ref
from repro_torch.core import (DeviceTables, HBMCPreconditioner,
                              backward_solve, backward_solve_batched,
                              build_plan, forward_solve,
                              forward_solve_batched, solve_iccg)
from repro_torch.core.sell import StepTables
from repro_torch.kernels import (hbmc_trisolve, hbmc_trisolve_batched,
                                 launch_counts, reset_launch_counts)
from repro_torch.kernels.ops import (DeviceRoundMajorTables,
                                     build_kernel_preconditioner)
from repro_torch.serve import PlanKey, SolverService, VirtualClock

BS, W = 8, 4
KNOBS = dict(method="hbmc", block_size=BS, w=W, device="cpu")
DTYPES = [(np.float64, torch.float64, 1e-12),
          (np.float32, torch.float32, 1e-5)]
DTYPE_IDS = ["f64", "f32"]
MATRICES = [("lap2d", laplace_2d(16, 16)), ("lap3d", laplace_3d(6, 6, 4)),
            ("graph", graph_laplacian(300, avg_degree=4, seed=1))]


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _jax_hbmc(a, bs=BS, w=W):
    """The reference's HBMC ordering, padded system, IC(0) factor and
    sweep StepTables of ``a``."""
    hb = j_hbmc_from_bmc(j_bmc_ordering(a, bs), w)
    a_hb, _ = j_pad_system_hbmc(a, None, hb)
    l = j_ic0(a_hb)
    return hb, a_hb, l, j_pack_factor_hbmc(l, hb)


def _steps(t) -> StepTables:
    """A JAX-side ``StepTables`` as the port's (numpy arrays throughout)."""
    return StepTables(rows=np.asarray(t.rows), cols=np.asarray(t.cols),
                      vals=np.asarray(t.vals), dinv=np.asarray(t.dinv),
                      n_slots=t.n_slots, live=np.asarray(t.live))


# ---------------------------------------------------------------------------
# B5 / B6 plain versions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("np_dt,dt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("bs,w", [(2, 2), (4, 4), (8, 8), (16, 3)])
def test_sweep_plain_matches_jax_oracle_and_pallas(bs, w, np_dt, dt, tol):
    _, _, _, (fwd, bwd) = _jax_hbmc(laplace_2d(14, 11), bs, w)
    rng = np.random.default_rng(bs * 10 + w)
    for steps in (fwd, bwd):
        rm = j_to_round_major(steps)
        cols, vals, dinv = (np.asarray(rm.cols), rm.vals.astype(np_dt),
                            rm.dinv.astype(np_dt))
        q = rng.normal(size=dinv.shape).astype(np_dt)
        qb = rng.normal(size=dinv.shape + (3,)).astype(np_dt)
        tc = [torch.from_numpy(x) for x in (cols, vals, dinv)]
        y = hbmc_trisolve(*tc, torch.from_numpy(q)).numpy()
        yb = hbmc_trisolve_batched(*tc, torch.from_numpy(qb)).numpy()
        jc = [jnp.asarray(x) for x in (cols, vals, dinv)]
        for want in (j_tri_ref(*jc, jnp.asarray(q)),
                     j_trisolve(*jc, jnp.asarray(q), interpret=True)):
            np.testing.assert_allclose(y, np.asarray(want), rtol=tol,
                                       atol=tol)
        for want in (j_tri_bref(*jc, jnp.asarray(qb)),
                     j_trisolve_batched(*jc, jnp.asarray(qb),
                                        interpret=True)):
            np.testing.assert_allclose(yb, np.asarray(want), rtol=tol,
                                       atol=tol)
        for j in range(qb.shape[-1]):
            np.testing.assert_array_equal(
                yb[:, j],
                hbmc_trisolve(*tc, torch.from_numpy(
                    np.ascontiguousarray(qb[..., j]))).numpy())


def test_sweep_wrappers_check_shapes():
    cols = torch.zeros(3, 4, 2, dtype=torch.int32)
    vals = torch.zeros(3, 4, 2, dtype=torch.float64)
    dinv = torch.ones(3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="rounds shape"):
        hbmc_trisolve(cols, vals, dinv, torch.zeros(2, 4, dtype=vals.dtype))
    with pytest.raises(ValueError, match="q shape"):
        hbmc_trisolve_batched(cols, vals, dinv,
                              torch.zeros(3, 4, dtype=vals.dtype))
    # the hole S*R and an index past it read 0
    cols[1:] = 12
    cols[2, :, 1] = 40
    q = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    np.testing.assert_array_equal(hbmc_trisolve(cols, vals, dinv, q).numpy(),
                                  q.reshape(-1).numpy())


# ---------------------------------------------------------------------------
# The kernel preconditioner and the index-space substitution.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,a", MATRICES, ids=[m[0] for m in MATRICES])
def test_kernel_preconditioner_matches_reference(name, a):
    hb, _, l, (fwd, bwd) = _jax_hbmc(a, bs=4, w=4)
    r = _rhs(hb.n_final, 4)
    real = ~hb.is_dummy
    pre = build_kernel_preconditioner(_steps(fwd), _steps(bwd), device="cpu")
    z = pre(torch.from_numpy(r)).numpy()
    z_j = np.asarray(j_build_kp(fwd, bwd, use_kernel=False)(jnp.asarray(r)))
    np.testing.assert_allclose(z, z_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(z[real], sequential_ic_solve(l, r)[real],
                               rtol=1e-11, atol=1e-11)
    assert (z[~real] == 0).all()
    rb = np.random.default_rng(5).normal(size=(hb.n_final, 3))
    zb = pre.apply_batched(torch.from_numpy(rb)).numpy()
    for j in range(3):
        np.testing.assert_array_equal(
            zb[:, j], pre(torch.from_numpy(rb[:, j].copy())).numpy())


def test_build_preconditioner_matches_sequential_oracles():
    """The port's own HBMC pipeline: ``build_preconditioner`` applies
    (L L^T)^{-1} as the sequential triangular solves do, and those equal
    the reference's on the same factor."""
    from repro.core.trisolve import sequential_backward as j_seq_bwd
    from repro.core.trisolve import sequential_forward as j_seq_fwd
    from repro_torch.core import (block_multicolor_ordering,
                                  build_preconditioner, hbmc_from_bmc, ic0,
                                  pad_system_hbmc, rounds_hbmc,
                                  sequential_backward, sequential_forward)
    a = laplace_2d(13, 9)
    hb = hbmc_from_bmc(block_multicolor_ordering(a, 8), 4)
    a_hb, _ = pad_system_hbmc(a, None, hb)
    l = ic0(a_hb)
    r = _rhs(hb.n_final, 13)
    pre = build_preconditioner(l, hb, device="cpu")
    live_rounds = [r for r in rounds_hbmc(hb) if (~hb.is_dummy[r]).any()]
    assert pre.n_rounds == len(live_rounds)
    y = sequential_forward(l, r)
    z = sequential_backward(l, y)
    np.testing.assert_array_equal(y, j_seq_fwd(l, r))
    np.testing.assert_array_equal(z, j_seq_bwd(l, y))
    real = ~hb.is_dummy
    np.testing.assert_allclose(pre(torch.from_numpy(r)).numpy()[real],
                               z[real], rtol=1e-11, atol=1e-11)


def test_round_major_tables_permute_by_distinct_scatters():
    """Both permutation indices are permutations of one buffer's rows: no
    two rows of a scatter land on one slot, and the live lanes map to their
    HBMC rows and back."""
    hb, _, _, (fwd, _) = _jax_hbmc(laplace_2d(13, 9), bs=8, w=4)
    t = DeviceRoundMajorTables.from_steps(_steps(fwd), device="cpu")
    n, m = t.n_slots - 1, t.rows.numel()
    assert hb.is_dummy.any() and (np.asarray(fwd.rows) == n).any()
    for index in (t.pos, t.rows):
        assert len(torch.unique(index)) == len(index)
        assert int(index.min()) >= 0 and int(index.max()) < t.n_buf
    rows = torch.from_numpy(np.asarray(fwd.rows, dtype=np.int64)).reshape(-1)
    live = torch.nonzero(rows < n).reshape(-1)
    assert torch.equal(t.rows[live], rows[live])
    assert torch.equal(t.pos[t.rows[live]], live)
    q = torch.from_numpy(_rhs(n, 12))
    q_rm = t.to_round_major(q).reshape(-1)
    assert torch.equal(q_rm[live], q[rows[live]])
    assert (q_rm[rows == n] == 0).all()
    assert torch.equal(t.from_round_major(q_rm)[rows[live]], q[rows[live]])


def test_round_major_layout_contract_of_the_port():
    """Mirror of tests/test_backends.py::test_round_major_layout_contract
    for the port's own tables: every live gather reads an earlier slice, so
    no launch of B5 reads what it writes."""
    a = laplace_2d(12, 10)
    plan = build_plan(a, layout="index", **KNOBS)
    for t in (plan._precond.kernel.fwd, plan._precond.kernel.bwd):
        cols, vals = t.cols.numpy(), t.vals.numpy()
        s_, r_, k_ = cols.shape
        slice_start = (np.arange(s_) * r_)[:, None, None]
        valid = vals != 0.0
        assert (cols[valid] < np.broadcast_to(slice_start,
                                              cols.shape)[valid]).all()
        # padding entries read the hole S*R, never a live slot
        assert (cols[~valid] == s_ * r_).all()


@pytest.mark.parametrize("name,a", MATRICES[:2], ids=["lap2d", "lap3d"])
def test_substitution_matches_reference(name, a):
    hb, _, _, (fwd, bwd) = _jax_hbmc(a)
    f, b = (DeviceTables.from_host(_steps(t), device="cpu")
            for t in (fwd, bwd))
    jf, jb = JDeviceTables.from_host(fwd), JDeviceTables.from_host(bwd)
    q = _rhs(hb.n_final, 1)
    y = forward_solve(f, torch.from_numpy(q)).numpy()
    y_j = np.asarray(j_forward_solve(jf, jnp.asarray(q)))
    np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-12)
    z = backward_solve(b, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(
        z, np.asarray(j_backward_solve(jb, jnp.asarray(y))), rtol=1e-12,
        atol=1e-12)
    # batched: column by column against the reference's single-RHS solves
    qb = np.random.default_rng(3).normal(size=(hb.n_final, 4))
    yb = forward_solve_batched(f, torch.from_numpy(qb)).numpy()
    zb = backward_solve_batched(b, torch.from_numpy(yb)).numpy()
    for j in range(qb.shape[1]):
        yj = np.asarray(j_forward_solve(jf, jnp.asarray(qb[:, j])))
        np.testing.assert_allclose(yb[:, j], yj, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            zb[:, j], np.asarray(j_backward_solve(jb, jnp.asarray(yb[:, j]))),
            rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(
            yb[:, j], forward_solve(f, torch.from_numpy(qb[:, j].copy()))
            .numpy())


@pytest.mark.parametrize("case", [("lap2d-14x12", laplace_2d(14, 12), 8, 4),
                                  ("lap2d-40x33", laplace_2d(40, 33), 16, 8),
                                  ("g3_circuit", None, 8, 4)],
                         ids=lambda c: c[0])
def test_index_apply_bitwise_equals_fused_apply(case):
    """The index layout's two sweeps (B5) give, on every live entry, the
    bits of the round-major layout's fused apply (B1) of the same r."""
    name, a, bs, w = case
    if a is None:
        a, _ = paper_problem(name, scale="tiny")
    knobs = dict(KNOBS, block_size=bs, w=w)
    p_idx = build_plan(a, layout="index", **knobs)
    p_rm = build_plan(a, layout="round_major", **knobs)
    real = ~p_idx._sysd.drop
    r = np.random.default_rng(6).normal(size=(p_idx.n_padded, 3))
    z_idx = p_idx._precond.apply_batched(torch.from_numpy(r)).numpy()
    z_rm = p_rm._rm.extract(p_rm._precond.apply_batched(
        torch.from_numpy(p_rm._rm.embed(r))).numpy())
    np.testing.assert_array_equal(z_idx[real], z_rm[real])
    z1 = p_idx._precond(torch.from_numpy(r[:, 0].copy())).numpy()
    z1_rm = p_rm._rm.extract(p_rm._precond(
        torch.from_numpy(p_rm._rm.embed(r[:, 0]))).numpy())
    np.testing.assert_array_equal(z1[real], z1_rm[real])


# ---------------------------------------------------------------------------
# The index-layout plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["sell", "ell"])
@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_index_solve_matches_reference_on_paper_problems(name, fmt):
    a, _ = paper_problem(name, scale="tiny")
    b = _rhs(a.shape[0], 7)
    kw = dict(method="hbmc", block_size=BS, w=W,
              shift=PAPER_SHIFTS.get(name, 0.0), spmv_format=fmt)
    rep = solve_iccg(a, b, layout="index", device="cpu", **kw)
    ref = j_solve_iccg(a, b, layout="index", backend="xla", **kw)
    rm = solve_iccg(a, b, layout="round_major", device="cpu", **kw)
    assert rep.layout == "index" and rep.backend == "torch"
    assert rep.result.status == ref.result.status == "CONVERGED"
    assert (rep.result.iterations == ref.result.iterations
            == rm.result.iterations)
    assert rep.n_rounds == ref.n_rounds
    np.testing.assert_allclose(rep.x, ref.x, rtol=1e-9,
                               atol=1e-9 * np.abs(ref.x).max())


@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_paper_semantics_counts_through_index_layout(name):
    """tests/test_paper_semantics.py's pinned counts, through the port's
    index layout: HBMC equals BMC, sits in its band, and beats nodal MC
    (within a few iterations on the ieej family)."""
    a, _ = paper_problem(name, scale="tiny")
    b = _rhs(a.shape[0], 7)
    its = {}
    for m in ("mc", "bmc", "hbmc"):
        rep = solve_iccg(a, b, method=m, block_size=BS, w=W,
                         shift=PAPER_SHIFTS.get(name, 0.0), layout="index",
                         device="cpu")
        assert rep.result.converged, (name, m)
        its[m] = rep.result.iterations
    expected = {"thermal2": 38, "parabolic_fem": 6, "g3_circuit": 21,
                "audikw_1": 21, "ieej": 31}
    assert its["hbmc"] == its["bmc"], its
    assert abs(its["hbmc"] - expected[name]) <= 2, its
    if name == "ieej":
        assert its["hbmc"] <= its["mc"] + 4, its
    else:
        assert its["hbmc"] <= its["mc"], its


@pytest.fixture(scope="module")
def index_plans():
    a = laplace_2d(16, 14)
    return (a, build_plan(a, layout="index", **KNOBS),
            j_build_plan(a, method="hbmc", block_size=BS, w=W,
                         layout="index", spmv_format="sell"))


def test_index_solve_batched_matches_singles_and_reference(index_plans):
    a, plan, jplan = index_plans
    bb = np.random.default_rng(8).normal(size=(a.shape[0], 3))
    bb[:, 1] *= 1e3
    reset_launch_counts()
    rep = plan.solve_batched(bb)
    assert set(launch_counts().values()) == {0}     # CPU: no launches
    jrep = jplan.solve_batched(bb)
    singles = [plan.solve(bb[:, j]).result.iterations for j in range(3)]
    np.testing.assert_array_equal(rep.result.iterations, singles)
    np.testing.assert_array_equal(rep.result.iterations,
                                  jrep.result.iterations)
    assert rep.result.status_names == ["CONVERGED"] * 3
    np.testing.assert_allclose(rep.x, jrep.x, rtol=1e-9,
                               atol=1e-9 * np.abs(jrep.x).max())


def test_index_solve_slab_contracts(index_plans):
    a, plan, _ = index_plans
    b = _rhs(a.shape[0], 9)
    assert plan.slab_m == plan.n_padded
    single = plan.solve(b)
    one = plan.solve_slab(b, slab_width=1)
    np.testing.assert_array_equal(
        one.x, plan.solve_batched(b[:, None]).x[:, 0])
    wide = plan.solve_slab(b, slab_width=3, slot=2)
    assert (one.result.iterations == wide.result.iterations
            == single.result.iterations)
    np.testing.assert_allclose(wide.x, single.x, rtol=1e-9, atol=1e-12)


def test_index_refactor_equals_fresh_plan():
    a = laplace_2d(12, 11)
    plan = build_plan(a, layout="index", spmv_format="ell", **KNOBS)
    a2 = (a * 2.5).tocsr()
    br = plan.refactor(a2)
    assert br.ordering == 0.0
    assert (plan.setup_count, plan.refactor_count) == (2, 1)
    b = _rhs(a.shape[0], 10)
    fresh = build_plan(a2, layout="index", spmv_format="ell", **KNOBS)
    np.testing.assert_array_equal(plan.solve(b).x, fresh.solve(b).x)


def test_index_nan_and_zero_rhs_statuses_match_reference(index_plans):
    a, plan, jplan = index_plans
    b_nan = _rhs(a.shape[0], 11)
    b_nan[4] = np.nan
    b_zero = np.zeros(a.shape[0])
    for b in (b_nan, b_zero):
        rep, jrep = plan.solve(b), jplan.solve(b)
        assert rep.result.status == jrep.result.status
        assert rep.result.iterations == jrep.result.iterations
    assert plan.solve(b_nan).result.status == "BREAKDOWN"
    zero = plan.solve(b_zero)
    assert zero.result.status == "CONVERGED" and zero.result.iterations == 0
    assert (zero.x == 0).all()
    both = plan.solve_batched(np.stack([b_nan, b_zero], axis=1))
    assert both.result.status_names == ["BREAKDOWN", "CONVERGED"]


@pytest.mark.parametrize("fmt", ["sell", "ell"])
def test_service_on_index_layout_is_bitwise_solve_slab(fmt):
    """Mirror of the reference's "index-xla" case of
    test_service_bitwise_on_other_backends."""
    knobs = dict(KNOBS, layout="index", spmv_format=fmt)
    a = laplace_2d(8, 8)
    rng = np.random.default_rng(17)
    svc = SolverService(slab_width=3, quantum=6, clock=VirtualClock(),
                        **knobs)
    bs = {}
    for i in range(5):
        b = rng.standard_normal(a.shape[0])
        bs[svc.submit(a, b, arrival_time=0.01 * i)] = b
    svc.drain()
    plan, status = svc.cache.get(a, **knobs)
    assert status == "hit" and plan.layout == "index"
    assert isinstance(plan._precond, HBMCPreconditioner)
    for rid, b in bs.items():
        c = svc.completed[rid]
        assert c.status == "CONVERGED"
        np.testing.assert_array_equal(
            c.x, plan.solve_slab(b, slab_width=3, slot=c.slot).x)
        assert c.iterations == plan.solve(b).result.iterations
    key, _ = PlanKey.from_matrix(a, **knobs)
    assert (key.layout, key.spmv_format) == ("index", fmt)
    for bad in (dict(layout="banana"), dict(spmv_format="csr")):
        with pytest.raises(ValueError, match="unknown"):
            PlanKey.from_matrix(a, **dict(knobs, **bad))
