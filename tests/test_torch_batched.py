"""The port's batched multi-RHS and slab path against the JAX reference.

* The batched plain versions (``kernels.ref``) on the CPU against the JAX
  oracles and the Pallas B3/B4 kernels in interpret mode, on numpy-seeded
  inputs.  Tolerance: f64 ``rtol = atol = 1e-12``, f32 ``1e-5`` (PyTorch
  and XLA may sum over K in another order).  Column j of a batched plain
  version is bitwise equal to the single-RHS plain version on column j.
* ``solve_batched`` on the five paper generators (tiny scale, B = 3)
  against the reference's all-kernel plan (Pallas, interpret mode): equal
  per-column iteration counts and statuses, x within 1e-10 relative.
* The batched health monitor (NaN / zero columns, DIVERGED, STAGNATED,
  ``record_history``) and the slab contracts within the port (B = 1 slab ==
  one-column batch, content independence, quantum independence, no shared
  state storage).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_plan as j_build_plan
from repro.core import pcg_batched as j_pcg_batched
from repro.core import solve_iccg_batched as j_solve_iccg_batched
from repro.core.matrices import PAPER_PROBLEMS, PAPER_SHIFTS, laplace_2d
from repro.core.matrices import paper_problem
from repro.kernels import hbmc_trisolve_fused_batched as j_trisolve_batched
from repro.kernels import sell_spmv_batched as j_sell_spmv_batched
from repro.kernels.ref import hbmc_trisolve_fused_batched_ref as j_tri_bref
from repro.kernels.ref import sell_spmv_batched_ref as j_spmv_bref
from repro.serve.faults import near_singular_matrix
from repro_torch.core import build_plan, pcg_batched, solve_iccg_batched
from repro_torch.core import status_name
from repro_torch.kernels import (hbmc_trisolve_batched, hbmc_trisolve_fused,
                                 hbmc_trisolve_fused_batched,
                                 hbmc_trisolve_shard_step_batched,
                                 launch_counts, reset_launch_counts,
                                 sell_spmv, sell_spmv_batched,
                                 sell_spmv_block)
from repro_torch.kernels.sell_spmv import MAX_UNROLL_K, batched_launch

BS, W = 8, 4
KNOBS = dict(method="hbmc", block_size=BS, w=W)
PALLAS = dict(spmv_format="sell", backend="pallas", spmv_backend="pallas",
              interpret=True)
DTYPES = [(np.float64, 1e-12), (np.float32, 1e-5)]
DTYPE_IDS = ["f64", "f32"]
SHAPES = [(1, 8, 1, 1), (3, 16, 4, 3), (6, 24, 7, 8)]


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _fused_inputs(s, r, k, nb, dtype, seed):
    """Random fused tables (step g never reads the slice it writes, as in
    every packed table) and a (S, R, B) right-hand side."""
    rng = np.random.default_rng(seed)
    m = s * r
    cols = rng.integers(0, m - r + 1, size=(2 * s, r, k))
    dest = np.array([g if g < s else 2 * s - 1 - g for g in range(2 * s)])
    skip = (cols >= (dest * r)[:, None, None]) & (cols < m - r)
    cols = np.where(skip | (cols == m - r), cols + r, cols).astype(np.int32)
    cols[0, 0, :] = m               # at least one hole read per table
    cols[-1, -1, 0] = -m            # and one wrapped negative index
    vals = (0.3 * rng.normal(size=(2 * s, r, k))).astype(dtype)
    dinv = rng.uniform(0.5, 1.5, size=(2 * s, r)).astype(dtype)
    q = rng.normal(size=(s, r, nb)).astype(dtype)
    return cols, vals, dinv, q


def _spmv_inputs(n, k, w, nb, dtype, seed):
    rng = np.random.default_rng(seed)
    n_slices = -(-n // w)
    # as jnp.take(fill_value=0): an index in [-n, 0) wraps, one in
    # [-n-3, -n) or [n, n+6) reads 0
    cols = rng.integers(-n - 3, n + 6, size=(n_slices, k, w)).astype(
        np.int32)
    vals = rng.normal(size=(n_slices, k, w)).astype(dtype)
    x = rng.normal(size=(n, nb)).astype(dtype)
    return vals, cols, x


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Kernels B3 / B4: plain versions vs the JAX oracles and Pallas kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("s,r,k,nb", SHAPES)
def test_trisolve_fused_batched_matches_jax(s, r, k, nb, dtype, tol):
    cols, vals, dinv, q = _fused_inputs(s, r, k, nb, dtype, seed=s + 10 * k)
    z = hbmc_trisolve_fused_batched(*_t(cols, vals, dinv, q)).numpy()
    assert z.dtype == dtype and z.shape == (s * r, nb)
    jargs = [jnp.asarray(a) for a in (cols, vals, dinv, q)]
    z_kernel = np.asarray(j_trisolve_batched(*jargs, interpret=True))
    z_ref = np.asarray(j_tri_bref(*jargs))
    np.testing.assert_allclose(z, z_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(z, z_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n,k,w,nb", [(13, 3, 4, 1), (64, 5, 8, 3),
                                      (100, 9, 1, 8), (40, 5, 8, 2),
                                      (37, 8, 4, 4), (64, 11, 8, 16),
                                      (30, 26, 4, 5)])
def test_sell_spmv_batched_matches_jax(n, k, w, nb, dtype, tol):
    """B in {2, 4, 16} and K past the kernel's unroll limit (8) are the
    shapes that pick distinct variants on the card (``batched_launch``)."""
    vals, cols, x = _spmv_inputs(n, k, w, nb, dtype, seed=n + k)
    y = sell_spmv_batched(*_t(vals, cols, x)).numpy()
    assert y.dtype == dtype and y.shape == (-(-n // w) * w, nb)
    jargs = [jnp.asarray(a) for a in (vals, cols, x)]
    y_kernel = np.asarray(j_sell_spmv_batched(*jargs, interpret=True))
    np.testing.assert_allclose(y, y_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(y, np.asarray(j_spmv_bref(*jargs)), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("s,r,k,nb", SHAPES)
def test_batched_plain_columns_bitwise_equal_single(s, r, k, nb, dtype, tol):
    """Column j of B3/B4's plain version == B1/B2's plain version on
    column j, bit for bit (both sum over k in order, one add at a time)."""
    cols, vals, dinv, q = _t(*_fused_inputs(s, r, k, nb, dtype, seed=7 * s))
    z = hbmc_trisolve_fused_batched(cols, vals, dinv, q)
    svals, scols, x = _t(*_spmv_inputs(s * r, k, 4, nb, dtype, seed=k))
    y = sell_spmv_batched(svals, scols, x)
    for j in range(nb):
        torch.testing.assert_close(
            z[:, j], hbmc_trisolve_fused(cols, vals, dinv,
                                         q[..., j].contiguous()),
            rtol=0, atol=0)
        torch.testing.assert_close(
            y[:, j], sell_spmv(svals, scols, x[:, j].contiguous()),
            rtol=0, atol=0)


def test_batched_nan_stays_in_its_column():
    """A NaN in one column of q reaches that column's lanes exactly as the
    reference's, and no other column."""
    cols, vals, dinv, q = _fused_inputs(3, 8, 3, 3, np.float64, seed=11)
    dinv[:, -2:] = 0.0                 # two padding lanes per round
    vals[:, -2:, :] = 0.0
    q[1, 3, 1] = np.nan
    z = hbmc_trisolve_fused_batched(*_t(cols, vals, dinv, q)).numpy()
    z_ref = np.asarray(j_tri_bref(*(jnp.asarray(a)
                                    for a in (cols, vals, dinv, q))))
    np.testing.assert_array_equal(np.isnan(z), np.isnan(z_ref))
    assert np.isnan(z[:, 1]).any()
    assert not np.isnan(z[:, [0, 2]]).any()


def _launch_coverage(launch, n_rows, nb):
    """How many threads of ``launch`` write each (row, column): the index
    math of ``sell_spmv_batched_kernel`` in ``csrc/sell_spmv.cu``."""
    groups = nb // launch.cols_per_thread
    b = np.arange(launch.blocks)
    chunk = (b % 2) * (launch.blocks // 2) + b // 2
    t = (chunk[:, None] * launch.threads
         + np.arange(launch.threads)[None, :]).ravel()
    t = t[t < n_rows * groups]
    row, col = t // groups, (t % groups) * launch.cols_per_thread
    hits = np.zeros((n_rows, nb), dtype=np.int64)
    for i in range(launch.cols_per_thread):
        np.add.at(hits, (row, col + i), 1)
    return hits


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nb,x_align,k", [
    (1, 0, 5), (2, 0, 5), (3, 0, 8), (4, 0, 9), (8, 0, 1), (8, 8, 5),
    (16, 0, 26), (5, 8, 26), (6, 0, 7), (12, 8, 8)])
def test_batched_launch_covers_every_entry_once(nb, x_align, k, dtype):
    """The variant ``batched_launch`` picks, and that its threads write
    every (row, column) of Y exactly once, at shapes around the vector
    width (2 columns of f64, 4 of f32), X on and off a 16-byte boundary,
    and K at, below and above the unroll limit."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // size
    for n_slices, w in ((3, 4), (70, 8), (513, 8)):
        launch = batched_launch(n_slices, k, w, nb, dtype, x_align)
        want_vec = nb % vec == 0 and x_align == 0
        assert launch.vector == want_vec
        assert launch.cols_per_thread == (vec if want_vec else 1)
        assert launch.k_unrolled == (k if k <= MAX_UNROLL_K else 0)
        assert launch.blocks % 2 == 0 and launch.threads == 256
        hits = _launch_coverage(launch, n_slices * w, nb)
        np.testing.assert_array_equal(hits, 1)


def test_batched_launch_refuses_what_no_variant_takes():
    with pytest.raises(ValueError, match="no batched SpMV variant"):
        batched_launch(4, 5, 8, 8, torch.float64, 4)     # X off 8 bytes
    with pytest.raises(ValueError, match="no batched SpMV variant"):
        batched_launch(4, 5, 8, 8, torch.float32, 2)
    with pytest.raises(TypeError, match="float32 or float64"):
        batched_launch(4, 5, 8, 8, torch.float16, 0)
    empty = batched_launch(0, 5, 8, 8, torch.float64, 0)
    assert empty.blocks == 0


def test_batched_wrappers_validate_and_count_no_cpu_launch():
    reset_launch_counts()
    cols, vals, dinv, q = _t(*_fused_inputs(2, 8, 2, 2, np.float64, seed=0))
    hbmc_trisolve_fused_batched(cols, vals, dinv, q)
    sell_spmv_batched(torch.zeros(2, 1, 4, dtype=torch.float64),
                      torch.zeros(2, 1, 4, dtype=torch.int32),
                      torch.zeros(8, 2, dtype=torch.float64))
    hbmc_trisolve_batched(cols[:2], vals[:2], dinv[:2], q)
    hbmc_trisolve_shard_step_batched(cols, vals, dinv, q,
                                     torch.zeros(q.shape[0] * q.shape[1],
                                                 q.shape[2],
                                                 dtype=torch.float64), 3, 0)
    sell_spmv_block(torch.zeros(2, 1, 4, dtype=torch.float64),
                    torch.zeros(2, 1, 4, dtype=torch.int32),
                    torch.zeros(8, 2, dtype=torch.float64))
    assert launch_counts() == {"hbmc_trisolve_fused": 0, "sell_spmv": 0,
                               "hbmc_trisolve_fused_batched": 0,
                               "sell_spmv_batched": 0, "hbmc_trisolve": 0,
                               "hbmc_trisolve_batched": 0,
                               "hbmc_trisolve_shard_step": 0,
                               "hbmc_trisolve_shard_step_batched": 0,
                               "sell_spmv_block": 0}
    with pytest.raises(ValueError, match="q shape"):
        hbmc_trisolve_fused_batched(cols, vals, dinv, q[..., 0])
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sell_spmv_batched(torch.empty(1, 1, 4, dtype=torch.float64, **meta),
                          torch.empty(1, 1, 4, dtype=torch.int32, **meta),
                          torch.empty(4, 2, dtype=torch.float64, **meta))


# ---------------------------------------------------------------------------
# solve_batched against the reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_solve_batched_matches_jax(name):
    a, _ = paper_problem(name, scale="tiny")
    shift = PAPER_SHIFTS.get(name, 0.0)
    b = np.random.default_rng(0).standard_normal((a.shape[0], 3))
    plan = build_plan(a, shift=shift, device="cpu", **KNOBS)
    rep = plan.solve_batched(b)
    jrep = j_build_plan(a, shift=shift, **KNOBS, **PALLAS).solve_batched(b)
    res, jres = rep.result, jrep.result
    np.testing.assert_array_equal(res.iterations, jres.iterations)
    np.testing.assert_array_equal(res.status, jres.status)
    assert res.status_names == ["CONVERGED"] * 3
    assert res.n_steps == jres.n_steps == res.iterations.max()
    np.testing.assert_allclose(rep.x, jrep.x, rtol=0,
                               atol=1e-10 * np.abs(jrep.x).max())
    assert rep.x.shape == (a.shape[0], 3)
    # per-column counts equal the single-RHS counts
    assert list(res.iterations) == [plan.solve(b[:, j]).result.iterations
                                    for j in range(3)]
    assert (rep.backend, rep.spmv_backend) == ("torch", "torch")


def test_solve_iccg_batched_matches_jax():
    a = laplace_2d(12, 10)
    b = np.random.default_rng(4).standard_normal((a.shape[0], 2))
    rep = solve_iccg_batched(a, b, device="cpu", **KNOBS)
    jrep = j_solve_iccg_batched(a, b, spmv_format="sell", **KNOBS)
    np.testing.assert_array_equal(rep.result.iterations,
                                  jrep.result.iterations)
    np.testing.assert_allclose(rep.x, jrep.x, rtol=1e-10, atol=1e-12)
    assert rep.setup_seconds > 0
    with pytest.raises(ValueError, match=r"\(n, B\)"):
        solve_iccg_batched(a, b[:, 0], device="cpu", **KNOBS)


# ---------------------------------------------------------------------------
# Batched health monitor (mirrors the batched half of test_faults.py).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plans():
    a = laplace_2d(6, 6)
    return (a, build_plan(a, device="cpu", **KNOBS),
            j_build_plan(a, **KNOBS, **PALLAS))


def test_nan_column_breakdown_beside_healthy(plans):
    a, plan, jplan = plans
    n = a.shape[0]
    b = np.stack([_rhs(n, 0), _rhs(n, 1), _rhs(n, 2)], axis=1)
    b_bad = b.copy()
    b_bad[5, 1] = np.nan
    mixed = plan.solve_batched(b_bad)
    assert mixed.result.status_names == ["CONVERGED", "BREAKDOWN",
                                         "CONVERGED"]
    assert list(mixed.result.converged) == [True, False, True]
    assert mixed.result.iterations[1] == 0
    assert np.isfinite(mixed.x).all()
    jmixed = jplan.solve_batched(b_bad)
    np.testing.assert_array_equal(mixed.result.iterations,
                                  jmixed.result.iterations)
    np.testing.assert_array_equal(mixed.result.status, jmixed.result.status)
    # healthy lanes bitwise vs the all-healthy batch at the same width
    clean = plan.solve_batched(b)
    np.testing.assert_array_equal(mixed.x[:, [0, 2]], clean.x[:, [0, 2]])


def test_zero_column_converges_at_zero(plans):
    a, plan, jplan = plans
    b = np.stack([_rhs(a.shape[0], 3), np.zeros(a.shape[0])], axis=1)
    rep, jrep = plan.solve_batched(b), jplan.solve_batched(b)
    assert rep.result.status_names == ["CONVERGED", "CONVERGED"]
    assert rep.result.iterations[1] == 0
    np.testing.assert_array_equal(rep.x[:, 1], np.zeros(a.shape[0]))
    np.testing.assert_array_equal(rep.result.iterations,
                                  jrep.result.iterations)
    np.testing.assert_array_equal(rep.result.relres[1], 0.0)


def _diag_op(d):
    return lambda v: d[:, None] * v


def test_pcg_batched_diverged_matches_jax():
    d = np.linspace(1.0, 10.0, 16)
    b = np.stack([_rhs(16, 5), _rhs(16, 6)], axis=1)
    res = pcg_batched(_diag_op(torch.from_numpy(d)), lambda v: v,
                      torch.from_numpy(b), divergence_factor=1e-6)
    jres = j_pcg_batched(_diag_op(jnp.asarray(d)), lambda v: v,
                         jnp.asarray(b), divergence_factor=1e-6)
    assert res.status_names == jres.status_names == ["DIVERGED", "DIVERGED"]
    np.testing.assert_array_equal(res.iterations, jres.iterations)
    assert np.isfinite(res.x).all()


def test_pcg_batched_stagnated_matches_jax():
    """Unpreconditioned CG on the near-singular Laplacian stalls well above
    rtol = 1e-14 and the stagnation window stops it (the RHS of the
    reference's own single-RHS STAGNATED test, and a second one that
    stalls as early).  A RHS that does not stall that early gives
    rounding-set counts at this rtol: the reference's own single and
    batched loops then disagree by up to ten iterations."""
    a = near_singular_matrix(6).toarray()
    b = np.stack([_rhs(36, 7), _rhs(36, 10)], axis=1)
    kw = dict(rtol=1e-14, maxiter=5000, stagnation_window=10)
    res = pcg_batched(lambda v: torch.from_numpy(a) @ v, lambda v: v,
                      torch.from_numpy(b), **kw)
    jres = j_pcg_batched(lambda v: jnp.asarray(a) @ v, lambda v: v,
                         jnp.asarray(b), **kw)
    assert res.status_names == jres.status_names == ["STAGNATED"] * 2
    np.testing.assert_array_equal(res.iterations, jres.iterations)
    assert (res.iterations < 5000).all()
    # knobs off: the same stalled solve runs to MAXITER exactly
    off = pcg_batched(lambda v: torch.from_numpy(a) @ v, lambda v: v,
                      torch.from_numpy(b), rtol=1e-14, maxiter=30,
                      divergence_factor=None, stagnation_window=None)
    assert off.status_names == ["MAXITER"] * 2
    assert list(off.iterations) == [30, 30] and off.n_steps == 30


def test_record_history_shape_and_nan_pattern_match_jax(plans):
    a, plan, jplan = plans
    n = a.shape[0]
    b = np.stack([_rhs(n, 9), np.zeros(n), _rhs(n, 10)], axis=1)
    rep = plan.solve_batched(b, maxiter=40, record_history=True)
    jrep = jplan.solve_batched(b, maxiter=40, record_history=True)
    h, jh = rep.result.history, jrep.result.history
    assert h.shape == jh.shape == (41, 3)
    np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
    ok = ~np.isnan(h)
    np.testing.assert_allclose(h[ok], jh[ok], rtol=1e-9, atol=1e-14)
    assert plan.solve_batched(b).result.history.shape == (0, 3)


def test_check_slab_errors(plans):
    a, plan, _ = plans
    n = plan.n
    with pytest.raises(ValueError, match=rf"\({n}, B\).*b\[:, None\]"):
        plan.solve_batched(np.ones(n))
    with pytest.raises(ValueError, match="expects b of shape"):
        plan.solve_batched(np.ones((n + 1, 2)))
    with pytest.raises(TypeError, match="float32.*float64"):
        plan.solve_batched(np.ones((n, 2), dtype=np.float32))
    # a non-float b is a convenience, not a precision hazard
    assert plan.solve_batched(np.ones((n, 1), dtype=int)).result \
        .converged.all()
    with pytest.raises(ValueError, match=r"\(n, B\).*b\[:, None\]"):
        pcg_batched(lambda x: x, lambda x: x, np.ones(8))


# ---------------------------------------------------------------------------
# Slab contracts within the port.
# ---------------------------------------------------------------------------

def test_solve_slab_width_1_is_one_column_batch(plans):
    a, plan, jplan = plans
    b = np.linspace(0.0, 1.0, plan.n)
    rep = plan.solve_batched(b[:, None])
    slab = plan.solve_slab(b, slab_width=1)
    np.testing.assert_array_equal(rep.x[:, 0], slab.x)
    assert slab.result.iterations == rep.result.iterations[0] \
        == plan.solve(b).result.iterations \
        == jplan.solve_slab(b, slab_width=1).result.iterations
    assert slab.result.status == "CONVERGED"


@pytest.mark.parametrize("width,slot", [(2, 0), (2, 1), (4, 2)])
def test_slab_columns_are_content_independent(width, slot):
    plan = build_plan(laplace_2d(7, 7), device="cpu", **KNOBS)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(plan.n)
    neighbor = rng.standard_normal(plan.n)
    alone = plan.solve_slab(b, slab_width=width, slot=slot)
    state = plan.new_slab_state(width)
    state.r[:, slot] = plan.embed_rhs(b)
    state.r[:, (slot + 1) % width] = plan.embed_rhs(neighbor)
    state, _ = plan.run_slab(state, quantum=10_000)
    np.testing.assert_array_equal(
        plan.extract_solution(state.x[:, slot]), alone.x)
    assert int(state.iters[slot]) == alone.result.iterations
    assert alone.result.iterations == plan.solve(b).result.iterations


def test_run_slab_quantum_boundaries_are_invisible(plans):
    """Repeated quantum=3 dispatches == one quantum=maxiter dispatch, bit
    for bit, and a dispatch never writes the state it was given."""
    a, plan, _ = plans
    width = 3
    bs = [_rhs(plan.n, 20 + j) for j in range(width)]
    state = plan.new_slab_state(width)
    for j, b in enumerate(bs):
        state.r[:, j] = plan.embed_rhs(b)
    one, steps_one = plan.run_slab(state, quantum=10_000)
    cur, total = state, 0
    while True:
        before = [t.clone() for t in cur]
        nxt, steps = plan.run_slab(cur, quantum=3)
        for t0, t1 in zip(before, cur):      # the input is untouched
            torch.testing.assert_close(t0, t1, rtol=0, atol=0,
                                       equal_nan=True)
        total += steps
        cur = nxt
        if steps < 3 or not bool(cur.active.any()):
            break
    assert total == steps_one
    for field in ("x", "r", "p", "rz", "iters", "relres", "status"):
        torch.testing.assert_close(getattr(cur, field), getattr(one, field),
                                   rtol=0, atol=0)
    assert [status_name(s) for s in one.status] == ["CONVERGED"] * width


def test_new_slab_state_fields_share_no_storage(plans):
    _, plan, _ = plans
    state = plan.new_slab_state(4)
    ptrs = [t.untyped_storage().data_ptr() for t in state]
    assert len(set(ptrs)) == len(ptrs)
    assert state.x.shape == (plan.slab_m, 4)
    assert state.fresh.all() and not state.active.any()
    assert state.iters.dtype == state.status.dtype == torch.int32
    with pytest.raises(ValueError, match="slab_width"):
        plan.new_slab_state(0)


def test_mixed_slab_healthy_columns_bitwise(plans):
    a, plan, _ = plans
    width, bad_slot = 4, 1
    cols = [_rhs(plan.n, s) for s in range(width)]

    def run(slab_cols):
        state = plan.new_slab_state(width)
        for s, col in enumerate(slab_cols):
            state.r[:, s] = plan.embed_rhs(np.asarray(col))
        state, _ = plan.run_slab(state, maxiter=400, quantum=400)
        return state

    bad = cols[bad_slot].copy()
    bad[7] = np.nan
    mixed = run(cols[:bad_slot] + [bad] + cols[bad_slot + 1:])
    clean = run(cols)
    assert status_name(mixed.status[bad_slot]) == "BREAKDOWN"
    assert not bool(mixed.active[bad_slot])
    for s in range(width):
        if s == bad_slot:
            continue
        assert status_name(mixed.status[s]) == "CONVERGED"
        torch.testing.assert_close(mixed.x[:, s], clean.x[:, s], rtol=0,
                                   atol=0)
        assert int(mixed.iters[s]) == int(clean.iters[s])


def test_solve_slab_matches_jax_and_validates(plans):
    a, plan, jplan = plans
    b = _rhs(plan.n, 31)
    rep = plan.solve_slab(b, slab_width=4, slot=2)
    jrep = jplan.solve_slab(b, slab_width=4, slot=2)
    assert rep.result.iterations == jrep.result.iterations
    assert rep.result.status == jrep.result.status == "CONVERGED"
    np.testing.assert_allclose(rep.x, jrep.x, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="solve_slab expects b of shape"):
        plan.solve_slab(np.ones((plan.n, 1)))
    with pytest.raises(ValueError, match="slot 4 out of range"):
        plan.solve_slab(b, slab_width=4, slot=4)
    with pytest.raises(ValueError, match="embed_rhs expects"):
        plan.embed_rhs(np.ones(plan.n + 1))
