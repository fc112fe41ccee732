"""The port's kernel wrappers on the CPU against the JAX kernels.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version.  It is
held against the Pallas kernel run as the JAX tests run it
(``interpret=True``) and against the reference's jnp oracle
(``repro.kernels.ref``), on the same numpy-seeded inputs.  Tolerance:
f64 ``rtol = atol = 1e-12``, f32 ``1e-5``, because PyTorch and XLA may sum
over K in a different order.  The CUDA kernels themselves are held against
the same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hbmc_trisolve_fused as j_trisolve_fused
from repro.kernels import sell_spmv as j_sell_spmv
from repro.kernels.ref import hbmc_trisolve_fused_ref as j_trisolve_ref
from repro.kernels.ref import sell_spmv_ref as j_sell_spmv_ref
from repro_torch.core import build_plan, paper_problem
from repro_torch.kernels import (hbmc_trisolve_fused, launch_counts,
                                 reset_launch_counts, sell_spmv, take_fill0)

DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)]
DTYPE_IDS = ["f64", "f32"]


def _fused_inputs(s, r, k, dtype, seed):
    """Random fused tables.  Step g reads any position (the hole S*R
    included) except the slice it writes, as in every packed table: lanes
    of one round are independent."""
    rng = np.random.default_rng(seed)
    m = s * r
    cols = rng.integers(0, m - r + 1, size=(2 * s, r, k))
    dest = np.array([g if g < s else 2 * s - 1 - g for g in range(2 * s)])
    skip = (cols >= (dest * r)[:, None, None]) & (cols < m - r)
    cols = np.where(skip | (cols == m - r), cols + r, cols).astype(np.int32)
    cols[0, 0, :] = m               # at least one hole read per table
    vals = (0.3 * rng.normal(size=(2 * s, r, k))).astype(dtype)
    dinv = rng.uniform(0.5, 1.5, size=(2 * s, r)).astype(dtype)
    q = rng.normal(size=(s, r)).astype(dtype)
    return cols, vals, dinv, q


def _port_trisolve(cols, vals, dinv, q):
    return hbmc_trisolve_fused(*(torch.from_numpy(np.ascontiguousarray(t))
                                 for t in (cols, vals, dinv, q))).numpy()


@pytest.mark.parametrize("np_dtype,t_dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("s,r,k", [(1, 8, 1), (3, 16, 4), (6, 24, 7)])
def test_trisolve_fused_matches_jax(s, r, k, np_dtype, t_dtype, tol):
    cols, vals, dinv, q = _fused_inputs(s, r, k, np_dtype, seed=s * 100 + k)
    z = _port_trisolve(cols, vals, dinv, q)
    assert z.dtype == np_dtype and z.shape == (s * r,)
    z_kernel = np.asarray(j_trisolve_fused(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(dinv),
        jnp.asarray(q), interpret=True))
    z_ref = np.asarray(j_trisolve_ref(jnp.asarray(cols), jnp.asarray(vals),
                                      jnp.asarray(dinv), jnp.asarray(q)))
    np.testing.assert_allclose(z, z_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(z, z_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("np_dtype,t_dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n,k,w", [(13, 3, 4), (64, 5, 8), (100, 9, 1)])
def test_sell_spmv_matches_jax(n, k, w, np_dtype, t_dtype, tol):
    rng = np.random.default_rng(n + k + w)
    n_slices = -(-n // w)
    # indices past the end of x (n, n+5) read 0, as jnp.take(fill_value=0)
    cols = rng.integers(0, n + 6, size=(n_slices, k, w)).astype(np.int32)
    vals = rng.normal(size=(n_slices, k, w)).astype(np_dtype)
    x = rng.normal(size=n).astype(np_dtype)
    y = sell_spmv(torch.from_numpy(vals), torch.from_numpy(cols),
                  torch.from_numpy(x)).numpy()
    assert y.dtype == np_dtype and y.shape == (n_slices * w,)
    y_kernel = np.asarray(j_sell_spmv(jnp.asarray(vals), jnp.asarray(cols),
                                      jnp.asarray(x), interpret=True))
    y_ref = np.asarray(j_sell_spmv_ref(jnp.asarray(vals), jnp.asarray(cols),
                                       jnp.asarray(x)))
    np.testing.assert_allclose(y, y_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(y, y_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["thermal2", "audikw_1"])
def test_kernels_on_plan_tables_match_jax(name):
    """The tables a real plan packs: holes, padding lanes, padded slices."""
    a, _ = paper_problem(name, scale="tiny")
    plan = build_plan(a, method="hbmc", block_size=8, w=4, device="cpu")
    t = plan._precond.tables
    rng = np.random.default_rng(3)
    q = rng.normal(size=(t.n_steps, t.lanes))
    z = hbmc_trisolve_fused(t.cols, t.vals, t.dinv, torch.from_numpy(q))
    z_kernel = j_trisolve_fused(jnp.asarray(t.cols.numpy()),
                                jnp.asarray(t.vals.numpy()),
                                jnp.asarray(t.dinv.numpy()), jnp.asarray(q),
                                interpret=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_kernel), rtol=1e-12,
                               atol=1e-12)
    x = rng.normal(size=plan._spmv_n)
    y = sell_spmv(plan._spmv_vals, plan._spmv_cols, torch.from_numpy(x))
    y_kernel = j_sell_spmv(jnp.asarray(plan._spmv_vals.numpy()),
                           jnp.asarray(plan._spmv_cols.numpy()),
                           jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_kernel), rtol=1e-12,
                               atol=1e-12)


def test_take_fill0_matches_jnp_take():
    v = np.arange(1.0, 8.0)
    idx = np.array([[0, 6, 7, 100], [-1, -7, -8, 3]], dtype=np.int32)
    got = take_fill0(torch.from_numpy(v), torch.from_numpy(idx)).numpy()
    want = np.asarray(jnp.take(jnp.asarray(v), jnp.asarray(idx), axis=0,
                               fill_value=0))
    np.testing.assert_array_equal(got, want)


def test_trisolve_nan_propagates_like_jax():
    """A NaN in q reaches exactly the lanes it reaches in the reference;
    padding lanes (vals = 0, dinv = 0) are multiplied, not skipped."""
    cols, vals, dinv, q = _fused_inputs(3, 8, 3, np.float64, seed=11)
    dinv[:, -2:] = 0.0                 # two padding lanes per round
    vals[:, -2:, :] = 0.0
    q[1, 3] = np.nan
    z = _port_trisolve(cols, vals, dinv, q)
    z_ref = np.asarray(j_trisolve_ref(jnp.asarray(cols), jnp.asarray(vals),
                                      jnp.asarray(dinv), jnp.asarray(q)))
    np.testing.assert_array_equal(np.isnan(z), np.isnan(z_ref))
    assert np.isnan(z).any()
    ok = ~np.isnan(z)
    np.testing.assert_allclose(z[ok], z_ref[ok], rtol=1e-12, atol=1e-12)


def test_cpu_wrappers_count_no_launch():
    reset_launch_counts()
    cols, vals, dinv, q = _fused_inputs(2, 8, 2, np.float64, seed=0)
    _port_trisolve(cols, vals, dinv, q)
    sell_spmv(torch.zeros(2, 1, 4, dtype=torch.float64),
              torch.zeros(2, 1, 4, dtype=torch.int32),
              torch.zeros(8, dtype=torch.float64))
    assert launch_counts() == {"hbmc_trisolve_fused": 0, "sell_spmv": 0,
                               "hbmc_trisolve_fused_batched": 0,
                               "sell_spmv_batched": 0}


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on the card is refused."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hbmc_trisolve_fused(torch.empty(2, 4, 1, dtype=torch.int32, **meta),
                            torch.empty(2, 4, 1, dtype=torch.float64, **meta),
                            torch.empty(2, 4, dtype=torch.float64, **meta),
                            torch.empty(1, 4, dtype=torch.float64, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        sell_spmv(torch.empty(1, 1, 4, dtype=torch.float64, **meta),
                  torch.empty(1, 1, 4, dtype=torch.int32, **meta),
                  torch.empty(4, dtype=torch.float64, **meta))


def test_trisolve_rejects_mismatched_q():
    cols, vals, dinv, q = _fused_inputs(2, 8, 2, np.float64, seed=0)
    with pytest.raises(ValueError, match="q shape"):
        _port_trisolve(cols, vals, dinv, q[:1])
