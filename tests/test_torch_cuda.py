"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the fixture, never at import).  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: max relative error 1e-12 in f64, 1e-5 in f32 -- the kernels sum
over K in order with each product rounded, the plain versions use PyTorch's
reduction order.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import build_plan, paper_problem
from repro_torch.core.matrices import laplace_2d
from repro_torch.kernels import (hbmc_trisolve_fused,
                                 hbmc_trisolve_fused_batched,
                                 hbmc_trisolve_fused_batched_ref,
                                 hbmc_trisolve_fused_ref, sell_spmv,
                                 sell_spmv_batched, sell_spmv_batched_ref,
                                 sell_spmv_ref)
from repro_torch.serve import SolverService, VirtualClock

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["thermal2", "g3_circuit", "audikw_1"])
def test_kernels_match_plain_on_card(cuda, name, dtype):
    a, _ = paper_problem(name, scale="tiny")
    plan = build_plan(a, block_size=8, w=4, dtype=dtype, device=cuda)
    t = plan._precond.tables
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes)),
                     device=cuda).to(dtype)
    x = torch.tensor(rng.normal(size=plan._spmv_n), device=cuda).to(dtype)
    before = kernels.launch_counts()
    z = hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q)
    y = sell_spmv(plan._spmv_vals, plan._spmv_cols, x)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "hbmc_trisolve_fused": 1, "sell_spmv": 1,
        "hbmc_trisolve_fused_batched": 0, "sell_spmv_batched": 0}
    assert _rel(z, hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q)) \
        <= TOL[dtype]
    assert _rel(y, sell_spmv_ref(plan._spmv_vals, plan._spmv_cols, x)) \
        <= TOL[dtype]


def test_trisolve_reads_hole_as_zero(cuda):
    """Every gather hits the hole S*R or a wrapped negative index."""
    s, r, k = 3, 40, 3
    m = s * r
    cols = torch.full((2 * s, r, k), m, dtype=torch.int32, device=cuda)
    cols[:, :, 1] = -3 * m          # outside [-m, m): reads 0
    vals = torch.ones(2 * s, r, k, dtype=torch.float64, device=cuda)
    dinv = torch.full((2 * s, r), 0.5, dtype=torch.float64, device=cuda)
    q = torch.arange(m, dtype=torch.float64, device=cuda).reshape(s, r)
    z = hbmc_trisolve_fused(cols, vals, dinv, q)
    torch.testing.assert_close(z, hbmc_trisolve_fused_ref(cols, vals, dinv,
                                                          q), rtol=0, atol=0)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    cols = torch.zeros(2, 4, 1, dtype=torch.int64, device=cuda)
    vals = torch.zeros(2, 4, 1, dtype=torch.float64, device=cuda)
    dinv = torch.zeros(2, 4, dtype=torch.float64, device=cuda)
    q = torch.zeros(1, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        hbmc_trisolve_fused(cols, vals, dinv, q)
    with pytest.raises(TypeError, match="float32 or float64"):
        sell_spmv(vals.to(torch.float16), cols.to(torch.int32),
                  torch.zeros(4, dtype=torch.float16, device=cuda))


def test_solve_on_card_matches_cpu(cuda):
    a = laplace_2d(30, 27)
    b = np.random.default_rng(1).normal(size=a.shape[0])
    kernels.reset_launch_counts()
    rep = build_plan(a, block_size=8, w=4, device=cuda).solve(b)
    counts = kernels.launch_counts()
    ref = build_plan(a, block_size=8, w=4, device="cpu").solve(b)
    assert rep.result.status == ref.result.status == "CONVERGED"
    assert abs(rep.result.iterations - ref.result.iterations) <= 1
    assert counts == {"hbmc_trisolve_fused": rep.result.iterations + 1,
                      "sell_spmv": rep.result.iterations,
                      "hbmc_trisolve_fused_batched": 0,
                      "sell_spmv_batched": 0}
    np.testing.assert_allclose(rep.x, ref.x, rtol=1e-6, atol=1e-8)
    assert rep.backend == "cuda"


@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["thermal2", "audikw_1"])
def test_batched_kernels_match_plain_and_single_on_card(cuda, name, dtype,
                                                        nb):
    """B3/B4 against their plain versions (tolerance) and, column for
    column, against B1/B2 (bitwise: same arithmetic in the same order)."""
    a, _ = paper_problem(name, scale="tiny")
    plan = build_plan(a, block_size=8, w=4, dtype=dtype, device=cuda)
    t = plan._precond.tables
    sv, sc = plan._spmv_vals, plan._spmv_cols
    rng = np.random.default_rng(nb)
    q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes, nb)),
                     device=cuda).to(dtype)
    x = torch.tensor(rng.normal(size=(plan._spmv_n, nb)),
                     device=cuda).to(dtype)
    before = kernels.launch_counts()
    z = hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, q)
    y = sell_spmv_batched(sv, sc, x)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "hbmc_trisolve_fused": 0, "sell_spmv": 0,
        "hbmc_trisolve_fused_batched": 1, "sell_spmv_batched": 1}
    assert _rel(z, hbmc_trisolve_fused_batched_ref(t.cols, t.vals, t.dinv,
                                                   q)) <= TOL[dtype]
    assert _rel(y, sell_spmv_batched_ref(sv, sc, x)) <= TOL[dtype]
    for j in range(nb):
        torch.testing.assert_close(
            z[:, j], hbmc_trisolve_fused(t.cols, t.vals, t.dinv,
                                         q[..., j].contiguous()),
            rtol=0, atol=0)
        torch.testing.assert_close(
            y[:, j], sell_spmv(sv, sc, x[:, j].contiguous()), rtol=0, atol=0)


def test_solve_batched_on_card_matches_cpu(cuda):
    a = laplace_2d(30, 27)
    b = np.random.default_rng(2).normal(size=(a.shape[0], 3))
    kernels.reset_launch_counts()
    rep = build_plan(a, block_size=8, w=4, device=cuda).solve_batched(b)
    counts = kernels.launch_counts()
    ref = build_plan(a, block_size=8, w=4, device="cpu").solve_batched(b)
    assert rep.result.status_names == ["CONVERGED"] * 3
    np.testing.assert_array_equal(rep.result.iterations,
                                  ref.result.iterations)
    assert counts == {"hbmc_trisolve_fused": 0, "sell_spmv": 0,
                      "hbmc_trisolve_fused_batched": rep.result.n_steps + 1,
                      "sell_spmv_batched": rep.result.n_steps}
    np.testing.assert_allclose(rep.x, ref.x, rtol=1e-9, atol=1e-11)


def test_service_on_card_is_bitwise_solve_slab(cuda):
    a = laplace_2d(16, 14)
    rng = np.random.default_rng(3)
    svc = SolverService(slab_width=4, quantum=8, clock=VirtualClock(),
                        method="hbmc", block_size=8, w=4, device=cuda)
    bs = {}
    for i in range(7):
        b = rng.standard_normal(a.shape[0])
        if i == 2:
            b[5] = np.nan
        bs[svc.submit(a, b, arrival_time=0.01 * i)] = b
    svc.drain()
    plan, status = svc.cache.get(a, method="hbmc", block_size=8, w=4,
                                 device=cuda)
    assert status == "hit"
    for rid, b in bs.items():
        c = svc.completed[rid]
        if np.isnan(b).any():
            assert c.status == "BREAKDOWN" and c.x is None
            continue
        assert c.status == "CONVERGED"
        np.testing.assert_array_equal(
            c.x, plan.solve_slab(b, slab_width=4, slot=c.slot).x)
