"""The port's GS/SOR smoothers (``repro_torch.core.smoothers``), mirroring
tests/test_smoothers.py, and held against the JAX reference's
``GSSmoother`` on the same tables and inputs (rtol 1e-12: the reference
sums each row with ``einsum``, the port in k order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.smoothers import build_gs_smoother as j_build_gs_smoother
from repro.core.smoothers import gs_solve as j_gs_solve
from repro_torch.core import (block_multicolor_ordering, hbmc_from_bmc,
                              pad_system, pad_system_hbmc)
from repro_torch.core.matrices import laplace_2d
from repro_torch.core.sell import rounds_bmc, rounds_hbmc, rounds_natural
from repro_torch.core.smoothers import build_gs_smoother, gs_solve


def _hbmc_system(a, b, bs, w):
    hb = hbmc_from_bmc(block_multicolor_ordering(a, bs), w)
    a_hb, b_hb = pad_system_hbmc(a, b, hb)
    return hb, a_hb, b_hb


def test_natural_gs_matches_hand_rolled_sweep():
    a = laplace_2d(10, 10)
    n = a.shape[0]
    b = np.random.default_rng(0).normal(size=n)
    sm = build_gs_smoother(a, rounds_natural(n), rounds_natural(n, True),
                           device="cpu")
    x1 = sm.sweep(torch.from_numpy(b), torch.zeros(n,
                                                   dtype=torch.float64))
    ad = a.toarray()
    xr = np.zeros(n)
    for i in range(n):
        xr[i] = (b[i] - ad[i] @ xr + ad[i, i] * xr[i]) / ad[i, i]
    np.testing.assert_allclose(x1.numpy(), xr, rtol=1e-12, atol=1e-12)


def test_gs_converges_and_bmc_hbmc_equivalent():
    a = laplace_2d(16, 12)
    b = np.random.default_rng(1).normal(size=a.shape[0])
    bmc = block_multicolor_ordering(a, 6)
    hb = hbmc_from_bmc(bmc, 3)
    a_bmc, b_bmc = pad_system(a, b, bmc)
    a_hb, b_hb = pad_system_hbmc(a, b, hb)
    sm_b = build_gs_smoother(a_bmc, rounds_bmc(bmc), rounds_bmc(bmc, True),
                             drop_mask=bmc.is_dummy, device="cpu")
    sm_h = build_gs_smoother(a_hb, rounds_hbmc(hb), rounds_hbmc(hb, True),
                             drop_mask=hb.is_dummy, device="cpu")
    xb, hist_b = gs_solve(sm_b, b_bmc, sweeps=100, a_bar=a_bmc)
    xh, hist_h = gs_solve(sm_h, b_hb, sweeps=100, a_bar=a_hb)
    assert hist_b[-1] < 0.2 * hist_b[0]
    assert all(np.diff(hist_h) < 0)
    # the paper's eq. 3.4 for GS: identical residual history, sweep for
    # sweep, and the same iterate in original coordinates
    np.testing.assert_allclose(hist_b, hist_h, rtol=1e-9)
    np.testing.assert_allclose(xb[bmc.perm], xh[hb.perm], rtol=1e-8,
                               atol=1e-10)


def test_sor_relaxation_accelerates():
    a = laplace_2d(14, 14)
    b = np.random.default_rng(2).normal(size=a.shape[0])
    hb, a_hb, b_hb = _hbmc_system(a, b, 4, 4)
    rounds_f, rounds_r = rounds_hbmc(hb), rounds_hbmc(hb, True)
    gs = build_gs_smoother(a_hb, rounds_f, rounds_r, drop_mask=hb.is_dummy,
                           device="cpu")
    sor = build_gs_smoother(a_hb, rounds_f, rounds_r, drop_mask=hb.is_dummy,
                            omega=1.5, device="cpu")
    _, h_gs = gs_solve(gs, b_hb, sweeps=60, a_bar=a_hb)
    _, h_sor = gs_solve(sor, b_hb, sweeps=60, a_bar=a_hb)
    assert h_sor[-1] < h_gs[-1], "SOR(1.5) should beat plain GS on Poisson"


@pytest.mark.parametrize("omega", [1.0, 1.5])
def test_sweeps_match_reference(omega):
    a = laplace_2d(15, 13)
    rng = np.random.default_rng(3)
    hb, a_hb, b_hb = _hbmc_system(a, rng.normal(size=a.shape[0]), 8, 4)
    args = (a_hb, rounds_hbmc(hb), rounds_hbmc(hb, True))
    sm = build_gs_smoother(*args, drop_mask=hb.is_dummy, omega=omega,
                           device="cpu")
    jsm = j_build_gs_smoother(*args, drop_mask=hb.is_dummy, omega=omega)
    x0 = rng.normal(size=hb.n_final)
    bt, xt = torch.from_numpy(b_hb), torch.from_numpy(x0)
    bj, xj = jnp.asarray(b_hb), jnp.asarray(x0)
    for got, want in (
            (sm.sweep(bt, xt), jsm.sweep(bj, xj)),
            (sm.sweep(bt, xt, reverse=True), jsm.sweep(bj, xj, reverse=True)),
            (sm.symmetric_sweep(bt, xt), jsm.symmetric_sweep(bj, xj))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_array_equal(xt.numpy(), x0)     # x0 is not written
    x, hist = gs_solve(sm, b_hb, sweeps=15, a_bar=a_hb)
    xj_out, hist_j = j_gs_solve(jsm, b_hb, sweeps=15, a_bar=a_hb)
    np.testing.assert_allclose(hist, hist_j, rtol=1e-12)
    np.testing.assert_allclose(x, xj_out, rtol=1e-12, atol=1e-12)


def test_smoother_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = laplace_2d(5, 5)
    n = a.shape[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_gs_smoother(a, rounds_natural(n), rounds_natural(n, True))
