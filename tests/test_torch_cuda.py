"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the fixture, never at import).  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: max relative error 1e-12 in f64, 1e-5 in f32 -- the kernels sum
over K in order with each product rounded, the plain versions use PyTorch's
reduction order.
"""
import importlib.util
import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch import kernels
from repro_torch.core import device_loop
from repro_torch.core.iccg import (_pcg_batched_device, _pcg_device,
                                   _pcg_slab_device)
from repro_torch.core import (PAPER_PROBLEMS, PAPER_SHIFTS, build_plan,
                              paper_problem)
from repro_torch.core.matrices import laplace_2d
from repro_torch.core.smoothers import build_gs_smoother, gs_solve
from repro_torch.kernels import (hbmc_trisolve, hbmc_trisolve_batched,
                                 hbmc_trisolve_batched_ref,
                                 hbmc_trisolve_fused,
                                 hbmc_trisolve_fused_batched,
                                 hbmc_trisolve_fused_batched_ref,
                                 hbmc_trisolve_fused_ref, hbmc_trisolve_ref,
                                 hbmc_trisolve_shard_step,
                                 hbmc_trisolve_shard_step_batched,
                                 hbmc_trisolve_shard_step_ref, sell_spmv,
                                 sell_spmv_batched, sell_spmv_batched_ref,
                                 sell_spmv_block, sell_spmv_ref)
from repro_torch.kernels import segments
from repro_torch.kernels.segments import barrier_segments, step_dest
from repro_torch.serve import SolverService, VirtualClock

from _torch_mesh_worker import shard_apply
from test_torch_segments import _own_chains

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _launched(**counts):
    """The launch counts of a run that launched only ``counts``."""
    return {**dict.fromkeys(kernels.launch_counts(), 0), **counts}


def _reset_counts():
    kernels.reset_launch_counts()
    device_loop.reset_loop_counts()


def _blocks(trips):
    """The PCG loop's blocks since ``_reset_counts``: ``ceil(trips / k)``
    of them, read one flag each; the first solve of a signature runs its
    first block eagerly and captures it, the rest are replays.  Every block
    launches k steps' kernels, masked steps included, so a solve launches
    ``1 + k * blocks`` preconditioner applies (one before the loop)."""
    k = device_loop._STEPS_PER_READ
    loops = device_loop.loop_counts()
    blocks = loops["blocks"]
    assert blocks == math.ceil(trips / k)
    assert loops["reads"] == blocks + 1
    assert loops["replays"] == blocks - loops["captures"]
    return k, blocks


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
    assert {k: after[k] - before[k] for k in after} == _launched(
        hbmc_trisolve_fused=1, sell_spmv=1)
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
    _reset_counts()
    rep = build_plan(a, block_size=8, w=4, device=cuda).solve(b)
    counts = kernels.launch_counts()
    k, blocks = _blocks(rep.result.iterations)
    assert device_loop.loop_counts()["captures"] == 1
    ref = build_plan(a, block_size=8, w=4, device="cpu").solve(b)
    assert rep.result.status == ref.result.status == "CONVERGED"
    assert abs(rep.result.iterations - ref.result.iterations) <= 1
    assert counts == _launched(hbmc_trisolve_fused=1 + k * blocks,
                               sell_spmv=k * blocks)
    np.testing.assert_allclose(rep.x, ref.x, rtol=1e-6, atol=1e-8)
    assert rep.backend == "cuda"


@pytest.mark.parametrize("nb", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["thermal2", "audikw_1"])
def test_batched_kernels_match_plain_and_single_on_card(cuda, name, dtype,
                                                        nb):
    """B3/B4 against their plain versions (tolerance) and, column for
    column, against B1/B2 (bitwise: same arithmetic in the same order).
    B4 runs its vector variant at B = 2, 8, 16 in f64 and 8, 16 in f32, its
    scalar variant otherwise; audikw_1's K is past the unroll limit."""
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
    assert {k: after[k] - before[k] for k in after} == _launched(
        hbmc_trisolve_fused_batched=1, sell_spmv_batched=1)
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


def _spmv_case(k, nb, dtype, device, seed, n=301, w=4):
    """SELL tables whose indices wrap ([-n, 0)) and fall outside [-n, n)
    (read 0), with zero padding entries, and an (n, B) X."""
    rng = np.random.default_rng(seed)
    ns = -(-n // w)
    cols = rng.integers(-n - 4, n + 4, size=(ns, k, w))
    vals = rng.normal(size=(ns, k, w))
    vals[:, k // 2:, w // 2:] = 0.0         # padding, multiplied all the same
    x = rng.normal(size=(n, nb))
    return (torch.tensor(vals, dtype=dtype, device=device),
            torch.tensor(cols, dtype=torch.int32, device=device),
            torch.tensor(x, dtype=dtype, device=device))


def _assert_b4(vals, cols, x, dtype):
    """B4 on x: one wrapper call and one CUDA launch, within TOL of the
    plain version, every column bitwise B2 on that column; returns y."""
    before = kernels.cuda_launch_counts()["sell_spmv_batched"]
    y = sell_spmv_batched(vals, cols, x)
    torch.cuda.synchronize()
    assert kernels.cuda_launch_counts()["sell_spmv_batched"] == before + 1
    ref = sell_spmv_batched_ref(vals, cols, x)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(y), fin)
    assert _rel(y[fin], ref[fin]) <= TOL[dtype]
    for j in range(x.shape[1]):
        torch.testing.assert_close(
            y[:, j], sell_spmv(vals, cols, x[:, j].contiguous()), rtol=0,
            atol=0, equal_nan=True)
    return y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("k", [5, 26])
def test_batched_spmv_on_an_offset_x(cuda, dtype, k):
    """X a contiguous view that starts one element into its storage (8
    bytes in f64, 4 in f32) runs the scalar variant, bitwise equal to
    the vector variant on an aligned copy of the same X."""
    from repro_torch.kernels.sell_spmv import batched_launch
    vals, cols, x = _spmv_case(k, 8, dtype, cuda, seed=k)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    x_off = buf[1:].view(x.shape)
    x_off.copy_(x)
    assert x_off.is_contiguous() and x_off.storage_offset() == 1
    assert x_off.data_ptr() % 16 != 0 and x.data_ptr() % 16 == 0
    ns, kk, w = vals.shape
    assert not batched_launch(ns, kk, w, 8, dtype, x_off.data_ptr() % 16
                              ).vector
    assert batched_launch(ns, kk, w, 8, dtype, x.data_ptr() % 16).vector
    assert torch.equal(_assert_b4(vals, cols, x_off, dtype),
                       _assert_b4(vals, cols, x, dtype))


@pytest.mark.parametrize("nb", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_batched_spmv_k26(cuda, dtype, nb):
    """K = 26, past the unroll limit: chunks of 8 and a tail of 2."""
    _assert_b4(*_spmv_case(26, nb, dtype, cuda, seed=nb), dtype)


@pytest.mark.parametrize("nb", [2, 3, 8])
@pytest.mark.parametrize("k", [5, 26])
def test_batched_spmv_nan_reaches_every_row_that_reads_it(cuda, k, nb):
    """A NaN at X[c, j] makes column j NaN in every row with an entry at c
    (a wrapped index or a zero padding entry included) and nowhere else."""
    vals, cols, x = _spmv_case(k, nb, torch.float64, cuda, seed=3 * k)
    n = x.shape[0]
    c, j = 17, nb - 1
    x[c, j] = float("nan")
    y = _assert_b4(vals, cols, x, torch.float64)
    cw = cols.long()
    cw = torch.where(cw < 0, cw + n, cw)
    reads = (cw == c).any(dim=1).reshape(-1)
    assert reads.any() and not reads.all()
    assert torch.equal(torch.isnan(y[:, j]), reads)
    others = [i for i in range(nb) if i != j]
    assert not torch.isnan(y[:, others]).any()


def test_solve_batched_on_card_matches_cpu(cuda):
    a = laplace_2d(30, 27)
    b = np.random.default_rng(2).normal(size=(a.shape[0], 3))
    _reset_counts()
    rep = build_plan(a, block_size=8, w=4, device=cuda).solve_batched(b)
    counts = kernels.launch_counts()
    k, blocks = _blocks(rep.result.n_steps)
    ref = build_plan(a, block_size=8, w=4, device="cpu").solve_batched(b)
    assert rep.result.status_names == ["CONVERGED"] * 3
    np.testing.assert_array_equal(rep.result.iterations,
                                  ref.result.iterations)
    assert rep.result.n_steps == ref.result.n_steps
    assert counts == _launched(
        hbmc_trisolve_fused_batched=1 + k * blocks,
        sell_spmv_batched=k * blocks)
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


@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["thermal2", "audikw_1"])
def test_sweep_kernels_match_plain_on_card(cuda, name, dtype, nb):
    """B5/B6 on both sweeps of an index plan against their plain versions,
    and each B6 column bitwise equal to B5 on that column."""
    a, _ = paper_problem(name, scale="tiny")
    plan = build_plan(a, block_size=8, w=4, dtype=dtype, layout="index",
                      device=cuda)
    rng = np.random.default_rng(nb)
    for t in (plan._precond.kernel.fwd, plan._precond.kernel.bwd):
        q = torch.tensor(rng.normal(size=tuple(t.dinv.shape)),
                         device=cuda).to(dtype)
        qb = torch.tensor(rng.normal(size=tuple(t.dinv.shape) + (nb,)),
                          device=cuda).to(dtype)
        before = kernels.launch_counts()
        y = hbmc_trisolve(t.cols, t.vals, t.dinv, q)
        yb = hbmc_trisolve_batched(t.cols, t.vals, t.dinv, qb)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after} == _launched(
            hbmc_trisolve=1, hbmc_trisolve_batched=1)
        assert _rel(y, hbmc_trisolve_ref(t.cols, t.vals, t.dinv, q)) \
            <= TOL[dtype]
        assert _rel(yb, hbmc_trisolve_batched_ref(t.cols, t.vals, t.dinv,
                                                  qb)) <= TOL[dtype]
        for j in range(nb):
            torch.testing.assert_close(
                yb[:, j], hbmc_trisolve(t.cols, t.vals, t.dinv,
                                        qb[..., j].contiguous()),
                rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["sell", "ell"])
def test_index_solve_on_card_matches_cpu(cuda, fmt):
    a = laplace_2d(30, 27)
    b = np.random.default_rng(4).normal(size=a.shape[0])
    knobs = dict(block_size=8, w=4, layout="index", spmv_format=fmt)
    _reset_counts()
    rep = build_plan(a, device=cuda, **knobs).solve(b)
    counts = kernels.launch_counts()
    k, blocks = _blocks(rep.result.iterations)
    ref = build_plan(a, device="cpu", **knobs).solve(b)
    assert rep.result.status == ref.result.status == "CONVERGED"
    assert abs(rep.result.iterations - ref.result.iterations) <= 1
    assert counts == _launched(
        hbmc_trisolve=2 * (1 + k * blocks),
        sell_spmv=k * blocks if fmt == "sell" else 0)
    np.testing.assert_allclose(rep.x, ref.x, rtol=1e-6, atol=1e-8)


def test_smoother_on_card_matches_cpu(cuda):
    a = laplace_2d(20, 17)
    rng = np.random.default_rng(5)
    plan = build_plan(a, block_size=8, w=4, layout="index", device="cpu")
    a_hb = plan._sysd.a_bar
    b = np.zeros(plan.n_padded)
    b[plan._perm] = rng.normal(size=a.shape[0])
    args = (a_hb, plan._sysd.fwd_rounds, plan._sysd.bwd_rounds)
    hists = [gs_solve(build_gs_smoother(*args, drop_mask=plan._sysd.drop,
                                        omega=1.5, device=dev), b,
                      sweeps=10, a_bar=a_hb)[1] for dev in (cuda, "cpu")]
    np.testing.assert_allclose(hists[0], hists[1], rtol=1e-12)
    assert all(np.diff(hists[0]) < 0)


# -- B1 / B3 / B5 / B6: one launch per barrier-free segment -----------------

def _segment_cases(plan, plan_idx):
    """(batched kernel, its plain version, the single-RHS kernel, table,
    slices of q) for a plan's fused table and its index plan's sweeps."""
    t, kp = plan._precond.tables, plan_idx._precond.kernel
    return ([(hbmc_trisolve_fused_batched, hbmc_trisolve_fused_batched_ref,
              hbmc_trisolve_fused, t, t.n_steps)]
            + [(hbmc_trisolve_batched, hbmc_trisolve_batched_ref,
                hbmc_trisolve, sw, sw.cols.shape[0])
               for sw in (kp.fwd, kp.bwd)])


def _cuda_launched(fn):
    before = kernels.cuda_launch_counts()
    out = fn()
    return out, sum(v - before[k]
                    for k, v in kernels.cuda_launch_counts().items())


@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("scheduler", ["coloring", "levelset"])
@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_segmented_kernels_bitwise_on_paper_plans(cuda, name, scheduler,
                                                  nb):
    """B3 and B6 with their tables' segments: bitwise the plain version,
    bitwise the per-step cut, each column bitwise B1's / B5's, and one CUDA
    launch per segment."""
    a, _ = paper_problem(name, scale="tiny")
    kw = dict(block_size=16, w=8, shift=PAPER_SHIFTS.get(name, 0.0),
              scheduler=scheduler, device=cuda)
    plan, plan_idx = build_plan(a, **kw), build_plan(a, layout="index", **kw)
    rng = np.random.default_rng(nb)
    for fn, ref, single, t, n_slices in _segment_cases(plan, plan_idx):
        q = torch.tensor(rng.normal(size=(n_slices, t.cols.shape[1], nb)),
                         device=cuda)
        z, n = _cuda_launched(lambda: fn(
            t.cols, t.vals, t.dinv, q, segments=t.segments))
        assert n == t.segments.size
        assert torch.equal(z, ref(t.cols, t.vals, t.dinv, q))
        step, n_step = _cuda_launched(lambda: fn(
            t.cols, t.vals, t.dinv, q, segments=np.arange(t.cols.shape[0])))
        assert n_step == t.cols.shape[0]
        assert torch.equal(z, step)
        for j in range(nb):
            assert torch.equal(z[:, j], single(t.cols, t.vals, t.dinv,
                                               q[..., j].contiguous()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("scheduler", ["coloring", "levelset"])
@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_single_rhs_kernels_bitwise_on_paper_plans(cuda, name, scheduler,
                                                   dtype):
    """B1 and B5 with their tables' segments: bitwise the plain version,
    bitwise the per-step cut, and one CUDA launch per segment."""
    a, _ = paper_problem(name, scale="tiny")
    kw = dict(block_size=16, w=8, shift=PAPER_SHIFTS.get(name, 0.0),
              scheduler=scheduler, dtype=dtype, device=cuda)
    plan, plan_idx = build_plan(a, **kw), build_plan(a, layout="index", **kw)
    rng = np.random.default_rng(5)
    for _, _, fn, t, n_slices in _segment_cases(plan, plan_idx):
        ref = (hbmc_trisolve_fused_ref if fn is hbmc_trisolve_fused
               else hbmc_trisolve_ref)
        q = torch.tensor(rng.normal(size=(n_slices, t.cols.shape[1])),
                         device=cuda).to(dtype)
        z, n = _cuda_launched(lambda: fn(
            t.cols, t.vals, t.dinv, q, segments=t.segments))
        assert n == t.segments.size
        assert torch.equal(z, ref(t.cols, t.vals, t.dinv, q))
        step, n_step = _cuda_launched(lambda: fn(
            t.cols, t.vals, t.dinv, q, segments=np.arange(t.cols.shape[0])))
        assert n_step == t.cols.shape[0]
        assert torch.equal(z, step)


def _random_table(s, r, k, fused, rng, device, dtype=torch.float64):
    """A random single-RHS table on the card with many cross-lane reads,
    wrapped and out-of-range positions and holes, none of another lane's
    entry of a step's own slice (and, for a sweep, none of a later slice):
    (cols as numpy, [cols, vals, dinv] on the card)."""
    m = s * r
    n_steps = 2 * s if fused else s
    dest = step_dest(n_steps, fused)
    cols = rng.integers(-m, m + 3, size=(n_steps, r, k))
    c = np.where(cols < 0, cols + m, cols)
    bad = (c // r == dest[:, None, None]) if fused else \
        (c // r >= dest[:, None, None])
    cols = np.where(bad, m, cols).astype(np.int32)
    t = [torch.tensor(x, device=device, dtype=dt) for x, dt in (
        (cols, torch.int32), (0.3 * rng.normal(size=(n_steps, r, k)), dtype),
        (rng.uniform(0.5, 1.5, size=(n_steps, r)), dtype))]
    return cols, t


@pytest.mark.parametrize("k", [1, 8, 11, 33, 80, 129])
def test_single_rhs_kernels_on_random_tables(cuda, k):
    """Random tables with many cross-lane reads, several blocks of lanes,
    and K below, at and past the entries the kernel prefetches (8), in f64
    and f32: B1 and B5 bitwise their plain versions with the computed
    segments, one per step, and None, with the launches of each path as
    the rule predicts.  Past 8 entries the lane-group path
    (``segments.lane_group``) runs each group size the rule picks: R = 300
    gives 8 threads a lane at K = 11 and 32 above, and on two rounds R =
    4,225 gives 16 (8 at K = 11), 33,792 gives 4 and 67,584 gives 2; a row
    of K = 129 runs in 2 chunks at G = 32, and rows run in 1 to 17 chunks
    at G = 2-16.  R = 67,585 takes the plain path."""
    rng = np.random.default_rng(k)
    shapes = [(5, 300)]
    if k > segments.ON_CHIP_MAX_K:
        shapes += [(2, 4_225), (2, 33_792), (2, 67_584),
                   (2, segments.GROUP_THREADS // 2 + 1)]
        assert [segments.lane_group(k, r) for _, r in shapes] == (
            [8, 8, 4, 2, 1] if k < 16 else [32, 16, 4, 2, 1])
    for (s, r), dtype, fused in itertools.product(
            shapes, (torch.float64, torch.float32), (True, False)):
        n_steps = 2 * s if fused else s
        cols, t = _random_table(s, r, k, fused, rng, cuda, dtype)
        q = torch.tensor(rng.normal(size=(s, r)), device=cuda).to(dtype)
        fn, ref = ((hbmc_trisolve_fused, hbmc_trisolve_fused_ref) if fused
                   else (hbmc_trisolve, hbmc_trisolve_ref))
        name = "hbmc_trisolve_fused" if fused else "hbmc_trisolve"
        want = ref(*t, q)
        seg = barrier_segments(cols, fused)
        for cut, launches in ((seg, seg.size), (np.arange(n_steps), n_steps),
                              (None, seg.size)):
            kernels.reset_launch_counts()
            z, n = _cuda_launched(lambda: fn(*t, q, segments=cut))
            assert n == launches and torch.equal(z, want), (r, dtype, fused,
                                                            cut)
            assert kernels.forwarding_counts()[name] == _paths(
                seg if cut is None else cut, n_steps, k, r, fused)
        assert (segments.lane_group(k, r) > 1) == (
            k > segments.ON_CHIP_MAX_K and r < 67_585)


@pytest.mark.parametrize("case", ["nan", "holes"])
@pytest.mark.parametrize("k", [11, 80])
def test_lane_group_path_nan_and_holes(cuda, k, case):
    """B1 and B5 on the lane-group path (R = 300): a NaN in q reaches the
    same entries, with the same bits elsewhere, as in the plain version
    (on a table of 20% live entries, so that it reaches some of them
    only); and a table with holes (the packing's S*R, and positions past
    it) in every row, first and last entries among them, stays bitwise."""
    s, r = 5, 300
    assert segments.lane_group(k, r) > 1
    rng = np.random.default_rng(100 + k)
    for fused in (True, False):
        cols, t = _random_table(s, r, k, fused, rng, cuda)
        m = s * r
        q = torch.tensor(rng.normal(size=(s, r)), device=cuda)
        holes = rng.random(cols.shape) < (0.8 if case == "nan" else 0.3)
        holes[..., 0] = holes[..., -1] = True
        cols = np.where(holes, rng.integers(m, m + 3, size=cols.shape),
                        cols).astype(np.int32)
        t[0] = torch.tensor(cols, device=cuda)
        if case == "nan":
            q[1, 7] = float("nan")
        fn, ref = ((hbmc_trisolve_fused, hbmc_trisolve_fused_ref) if fused
                   else (hbmc_trisolve, hbmc_trisolve_ref))
        want = ref(*t, q)
        seg = barrier_segments(cols, fused)
        for cut in (seg, np.arange(cols.shape[0])):
            z = fn(*t, q, segments=cut)
            torch.testing.assert_close(z, want, rtol=0, atol=0,
                                       equal_nan=True)
        if case == "nan":
            assert torch.isnan(z).any() and not torch.isnan(z).all()


def test_segmented_kernels_repeat_bitwise(cuda):
    """20 calls on one input give one result: a race shows as a bit."""
    coeff = np.exp(np.random.default_rng(1).normal(0, 1, size=(256, 256)))
    a = laplace_2d(256, 256, coeff)
    kw = dict(block_size=16, w=8, device=cuda)
    plan, plan_idx = build_plan(a, **kw), build_plan(a, layout="index", **kw)
    rng = np.random.default_rng(0)
    for fn, _, single, t, n_slices in _segment_cases(plan, plan_idx):
        assert t.segments.size == (3 if n_slices * 2 == t.cols.shape[0]
                                   else 2)
        q = torch.tensor(rng.normal(size=(n_slices, t.cols.shape[1], 8)),
                         device=cuda)
        for f, qq in ((fn, q), (single, q[..., 0].contiguous())):
            z0 = f(t.cols, t.vals, t.dinv, qq, segments=t.segments)
            for _ in range(19):
                assert torch.equal(f(t.cols, t.vals, t.dinv, qq,
                                     segments=t.segments), z0)


def test_segmented_kernels_propagate_nan(cuda):
    a, _ = paper_problem("thermal2", scale="tiny")
    kw = dict(block_size=16, w=8, device=cuda)
    plan, plan_idx = build_plan(a, **kw), build_plan(a, layout="index", **kw)
    for fn, ref, _, t, n_slices in _segment_cases(plan, plan_idx):
        q = torch.ones((n_slices, t.cols.shape[1], 3), device=cuda,
                       dtype=torch.float64)
        q[1, 2, 1] = float("nan")
        z = fn(t.cols, t.vals, t.dinv, q, segments=t.segments)
        want = ref(t.cols, t.vals, t.dinv, q)
        assert torch.isnan(z[:, 1]).any() and not torch.isnan(z[:, 0]).any()
        torch.testing.assert_close(z, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("seed", range(3))
def test_segmented_kernels_with_fewer_lanes_than_a_block(cuda, seed):
    """R of 5 lanes (far fewer threads than one block), random tables with
    many cross-lane reads: many segments, still bitwise."""
    s, r, k = 4, 5, 3
    m = s * r
    rng = np.random.default_rng(seed)
    for fused in (True, False):
        n_steps = 2 * s if fused else s
        cols = rng.integers(-m, m + 3, size=(n_steps, r, k))
        dest = step_dest(n_steps, fused)
        own = (np.where(cols < 0, cols + m, cols) // r) == \
            dest[:, None, None]
        cols = np.where(own, m, cols).astype(np.int32)
        if not fused:        # a sweep reads earlier slices only
            cols = np.where(np.where(cols < 0, cols + m, cols) // r
                            > dest[:, None, None], m, cols).astype(np.int32)
        seg = barrier_segments(cols, fused)
        c = np.where(cols < 0, cols + m, cols)
        ahead = (c < m) & (c // r >= dest[:, None, None])
        assert ahead[:s].any() == fused   # the kernel's read mask matters
        t = [torch.tensor(x, device=cuda) for x in (
            cols, 0.3 * rng.normal(size=(n_steps, r, k)),
            rng.uniform(0.5, 1.5, size=(n_steps, r)))]
        for nb in (1, 3):
            q = torch.tensor(rng.normal(size=(s, r, nb)), device=cuda)
            fn, ref = ((hbmc_trisolve_fused_batched,
                        hbmc_trisolve_fused_batched_ref) if fused else
                       (hbmc_trisolve_batched, hbmc_trisolve_batched_ref))
            z, n = _cuda_launched(lambda: fn(*t, q, segments=seg))
            assert n == seg.size
            assert torch.equal(z, ref(*t, q))
            # None computes the same segments from cols on the host
            z_none, n_none = _cuda_launched(lambda: fn(*t, q))
            assert n_none == seg.size and torch.equal(z_none, z)


def test_segment_arguments_are_checked(cuda):
    a, _ = paper_problem("ieej", scale="tiny")
    t = build_plan(a, block_size=16, w=8, device=cuda)._precond.tables
    q = torch.zeros((t.n_steps, t.lanes, 2), device=cuda,
                    dtype=torch.float64)
    g = 2 * t.n_steps
    for bad in ([1, 5], [0, 5, 5], [0, g], [], [[0, 1]]):
        with pytest.raises(ValueError, match="segments"):
            hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, q,
                                        segments=bad)
        with pytest.raises(ValueError, match="segments"):
            hbmc_trisolve_fused(t.cols, t.vals, t.dinv,
                                q[..., 0].contiguous(), segments=bad)
        with pytest.raises(ValueError, match="segments"):
            hbmc_trisolve(t.cols[:t.n_steps].contiguous(),
                          t.vals[:t.n_steps].contiguous(),
                          t.dinv[:t.n_steps].contiguous(),
                          q[..., 0].contiguous(), segments=bad)


def _paths(starts, n_steps, k, r, fused):
    """The launches of a cut on each path of B1 / B5, by the codes
    ``segments.single_paths`` gives its segments."""
    codes = segments.single_paths(k, r, n_steps // 2 if fused else n_steps,
                                  starts, fused)
    return {"on_chip": int((codes == segments.ON_CHIP).sum()),
            "plain": int((codes == segments.PLAIN).sum()),
            "grouped": int((codes > segments.ON_CHIP).sum())}


@pytest.mark.parametrize("fused", [True, False], ids=["B1", "B5"])
@pytest.mark.parametrize("k, code", [(9, 1), (11, 3)],
                         ids=["on-chip-at-k9", "group-of-3"])
def test_single_rhs_entry_refuses_a_path_its_kernel_cannot_take(cuda, fused,
                                                                k, code):
    """A path code passed straight to the C entry point against its
    kernel's preconditions: the on-chip path past KP (8) entries a row, a
    lane group that is not a power of two.  The entry refuses it before
    any launch (cudaErrorInvalidValue, 1); the codes ``single_paths``
    gives launch the same table, bitwise the plain version."""
    from repro_torch.kernels import _build
    s, r = 3, 300
    cols, t = _random_table(s, r, k, fused, np.random.default_rng(k), cuda)
    q = torch.tensor(np.random.default_rng(1).normal(size=(s, r)),
                     device=cuda)
    y = torch.empty(s * r, dtype=torch.float64, device=cuda)
    seg = barrier_segments(cols, fused)
    entry = "hbmc_trisolve_fused_f64" if fused else "hbmc_trisolve_f64"
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(paths):
        return _build.call(entry, *(x.data_ptr() for x in (*t, q, y)), s, r,
                           k, seg.ctypes.data, int(seg.size),
                           paths.ctypes.data, stream)

    with pytest.raises(RuntimeError, match=r"cudaError_t 1$"):
        launch(np.full(seg.size, code, dtype=np.int32))
    assert launch(segments.single_paths(k, r, s, seg, fused)) == seg.size
    ref = hbmc_trisolve_fused_ref if fused else hbmc_trisolve_ref
    assert torch.equal(y, ref(*t, q))


def _fem2d_p1(n):
    """The thermal2 cell's matrix family (P1 triangles) on an n x n grid."""
    path = (Path(__file__).resolve().parents[1] / "portbench" / "matrices"
            / "fem2d_p1_lognormal.py")
    spec = importlib.util.spec_from_file_location("_fem2d_p1", path)
    fem = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fem)
    return fem.make({"nx": n, "ny": n, "sigma": 1.0},
                    np.random.default_rng(0))


def _portbench_module(kind, name):
    path = (Path(__file__).resolve().parents[1] / "portbench" / kind
            / f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_portbench_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module       # its dataclasses look it up
    spec.loader.exec_module(module)
    return module


def _q1_elasticity(m):
    """The audikw_1 cell's matrix family (Q1-brick elasticity, 81-entry
    rows) at m bricks a side."""
    return _portbench_module("matrices", "fem3d_q1_elasticity").make(
        {"m": m, "nu": 0.3, "sigma": 1.0}, np.random.default_rng(0))


def test_q1_elasticity_plan_matches_the_plain_reference(cuda):
    """The audikw_1 cell's plan (block 16, w 8, SELL, round-major, f64) at
    8 bricks a side on the card, B1 on its lane-group path (the plan's few
    lanes: ``segments.lane_group``) and B2 on its wide-row path, against
    the plain reference in the plan's ordering
    (``portbench/reference/iccg_plain.py``, on the CPU): one apply to
    1e-12, the iteration count and status exactly, the solution to 1e-10;
    and B1 bitwise B3's column 0 on the plan's table."""
    plain = _portbench_module("reference", "iccg_plain")
    a = _q1_elasticity(8)
    plan = build_plan(a, block_size=16, w=8, device=cuda)
    factor = plain.ic0(a, plan._perm)
    b = np.random.default_rng(8).normal(size=a.shape[0])
    t = plan._precond.tables
    assert segments.lane_group(t.cols.shape[2], t.lanes) > 1
    kernels.reset_launch_counts()
    z = plan.extract_solution(plan._precond(plan.embed_rhs(b)))
    assert kernels.forwarding_counts()["hbmc_trisolve_fused"] == _paths(
        t.segments, 2 * t.n_steps, t.cols.shape[2], t.lanes, True)
    assert kernels.forwarding_counts()["hbmc_trisolve_fused"]["grouped"] > 0
    qb = torch.tensor(np.random.default_rng(9).normal(
        size=(t.n_steps, t.lanes, 3)), device=cuda)
    assert torch.equal(
        hbmc_trisolve_fused(t.cols, t.vals, t.dinv, qb[..., 0].contiguous(),
                            segments=t.segments),
        hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, qb,
                                    segments=t.segments)[:, 0])
    want = plain.apply(factor, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(z - want) <= 1e-12 * np.linalg.norm(want)
    rep = plan.solve(b, rtol=1e-7)
    ref = plain.pcg(a, b, factor, rtol=1e-7)
    assert (rep.result.iterations, rep.result.status) == (ref.iterations,
                                                          ref.status)
    assert ref.status == "CONVERGED"
    assert np.linalg.norm(rep.x - ref.x) <= 1e-10 * np.linalg.norm(ref.x)


def _on_chip_cases(case):
    """(label, fused, (cols, vals, dinv) as numpy, cuts) of one case."""
    kind, k = case
    if kind == "p1":
        a = _fem2d_p1(300)
        kw = dict(block_size=16, w=8, device="cpu")
        t = build_plan(a, **kw)._precond.tables
        kp = build_plan(a, layout="index", **kw)._precond.kernel
        return [(lab, fused, (x.cols.numpy(), x.vals.numpy(),
                              x.dinv.numpy()), [x.segments])
                for lab, x, fused in (("fused", t, True),
                                      ("fwd", kp.fwd, False),
                                      ("bwd", kp.bwd, False))]
    s, r = 40, 300
    rng = np.random.default_rng(k)
    got = []
    for fused in (True, False):
        n_steps = 2 * s if fused else s
        cols = _own_chains(s, r, k, fused, seed=k)
        tab = (cols, 0.3 * rng.normal(size=cols.shape),
               rng.uniform(0.5, 1.5, size=cols.shape[:2]))
        assert barrier_segments(cols, fused).tolist() == [0]
        cuts = [np.array([0]), np.arange(0, n_steps, 2),
                np.arange(0, n_steps, 16), np.arange(0, n_steps, 32),
                np.array([0, 1, 3, 6])]
        if fused:      # one launch across the turn, one per half
            cuts += [np.array([0, s - 9, s + 23]), np.array([0, s])]
        got.append((f"chains fused={fused}", fused, tab, cuts))
    return got


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", [("chains", 3), ("chains", 6),
                                  ("chains", 8), ("chains", 11), ("p1", 0)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_single_rhs_on_chip_path_bitwise_plain_and_per_step_cut(cuda, case,
                                                                dtype):
    """B1 and B5 on the on-chip path: own-lane chains at distances from 1
    to past the ring (RING_STEPS), launches of 1, 2, 3, 16, 32 and 2S
    steps and one across the fused table's turn, K odd, even, at
    ON_CHIP_MAX_K (8) and past it (11: the lane-group path, 8 threads a
    lane); and the P1-triangle plan of block 16, w 8 whose launches run
    8-32 steps, as the thermal2 cell's.  Bitwise the plain version and the
    per-step cut (every launch off the on-chip path), with the launches of
    each path counted."""
    for lab, fused, tab, cuts in _on_chip_cases(case):
        cols, vals, dinv = (torch.tensor(x, device=cuda) for x in tab)
        vals, dinv = vals.to(dtype), dinv.to(dtype)
        n_steps = cols.shape[0]
        s = n_steps // 2 if fused else n_steps
        q = torch.tensor(np.random.default_rng(len(lab)).normal(
            size=(s, cols.shape[1])), device=cuda).to(dtype)
        fn, ref = ((hbmc_trisolve_fused, hbmc_trisolve_fused_ref) if fused
                   else (hbmc_trisolve, hbmc_trisolve_ref))
        name = "hbmc_trisolve_fused" if fused else "hbmc_trisolve"
        want = ref(cols, vals, dinv, q)
        kernels.reset_launch_counts()
        step = fn(cols, vals, dinv, q, segments=np.arange(n_steps))
        assert kernels.forwarding_counts()[name] == _paths(
            np.arange(n_steps), n_steps, cols.shape[2], cols.shape[1], fused)
        assert torch.equal(step, want), lab
        served = 0
        for cut in cuts:
            kernels.reset_launch_counts()
            z = fn(cols, vals, dinv, q, segments=cut)
            assert torch.equal(z, want), (lab, cut.tolist())
            assert kernels.forwarding_counts()[name] == _paths(
                cut, n_steps, cols.shape[2], cols.shape[1], fused)
            served += segments.forwarded_reads(tab[0], cut, fused).sum()
        assert (served > 0) == (cols.shape[2] <= segments.ON_CHIP_MAX_K), lab


def test_cuda_launch_counts_per_kernel(cuda):
    """The CUDA launches each wrapper reports: one per segment of B1 / B3 /
    B5 / B6, one per call of B2 / B4 and of the shard steps;
    ``sell_spmv_block``'s are B4's too."""
    a, _ = paper_problem("ieej", scale="tiny")
    kw = dict(block_size=16, w=8, device=cuda)
    plan, plan_idx = build_plan(a, **kw), build_plan(a, layout="index", **kw)
    t, sw = plan._precond.tables, plan_idx._precond.kernel.fwd
    sv, sc = plan._spmv_vals, plan._spmv_cols
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes, 3)), device=cuda)
    qs = torch.tensor(rng.normal(size=tuple(sw.dinv.shape) + (3,)),
                      device=cuda)
    x = torch.tensor(rng.normal(size=(plan._spmv_n, 3)), device=cuda)
    kernels.reset_launch_counts()
    hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q[..., 0].contiguous(),
                        segments=t.segments)
    hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, q,
                                segments=t.segments)
    hbmc_trisolve(sw.cols, sw.vals, sw.dinv, qs[..., 0].contiguous(),
                  segments=sw.segments)
    hbmc_trisolve_batched(sw.cols, sw.vals, sw.dinv, qs,
                          segments=sw.segments)
    sell_spmv(sv, sc, x[:, 0].contiguous())
    sell_spmv_batched(sv, sc, x)
    y = torch.empty(t.n_steps * t.lanes, 3, dtype=q.dtype, device=cuda)
    hbmc_trisolve_shard_step(t.cols, t.vals, t.dinv,
                             q[..., 0].contiguous(), y[:, 0].contiguous(), 0,
                             0)
    hbmc_trisolve_shard_step_batched(t.cols, t.vals, t.dinv, q, y, 0, 0)
    sell_spmv_block(sv, sc, x)
    assert kernels.cuda_launch_counts() == {
        "hbmc_trisolve_fused": t.segments.size, "sell_spmv": 1,
        "hbmc_trisolve_fused_batched": t.segments.size,
        "sell_spmv_batched": 2, "hbmc_trisolve": sw.segments.size,
        "hbmc_trisolve_batched": sw.segments.size,
        "hbmc_trisolve_shard_step": 1,
        "hbmc_trisolve_shard_step_batched": 1, "sell_spmv_block": 1}
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.launch_counts(), 1), "sell_spmv_batched": 2}
    assert kernels.forwarding_counts() == {
        "hbmc_trisolve_fused": _paths(t.segments, 2 * t.n_steps,
                                      t.cols.shape[2], t.lanes, True),
        "hbmc_trisolve": _paths(sw.segments, sw.cols.shape[0],
                                sw.cols.shape[2], sw.cols.shape[1], False)}
    assert kernels.forwarding_counts()["hbmc_trisolve_fused"]["on_chip"] > 0
    # the lane-group path: the audikw_1 cell's matrix family, K = 80, on
    # few lanes
    a = _q1_elasticity(4)
    wide = build_plan(a, **kw)._precond.tables
    wide_idx = build_plan(a, layout="index", **kw)._precond.kernel.fwd
    assert wide.cols.shape[2] > segments.ON_CHIP_MAX_K
    kernels.reset_launch_counts()
    hbmc_trisolve_fused(wide.cols, wide.vals, wide.dinv,
                        torch.zeros(wide.n_steps, wide.lanes,
                                    dtype=torch.float64, device=cuda),
                        segments=wide.segments)
    hbmc_trisolve(wide_idx.cols, wide_idx.vals, wide_idx.dinv,
                  torch.zeros(tuple(wide_idx.dinv.shape), dtype=torch.float64,
                              device=cuda), segments=wide_idx.segments)
    assert segments.lane_group(wide.cols.shape[2], wide.lanes) == 32
    assert kernels.forwarding_counts() == {
        "hbmc_trisolve_fused": {"on_chip": 0, "plain": 0,
                                "grouped": int(wide.segments.size)},
        "hbmc_trisolve": {"on_chip": 0, "plain": 0,
                          "grouped": int(wide_idx.segments.size)}}
    assert segments.analysed() == [
        segments.Analysed(True, 2 * wide.n_steps, wide.lanes,
                          wide.cols.shape[2], int(wide.segments.size)),
        segments.Analysed(False, *wide_idx.cols.shape,
                          int(wide_idx.segments.size))]


@pytest.mark.parametrize("fused", [True, False])
def test_trisolve_kernels_ignore_the_output_buffers_old_values(cuda, fused):
    """The kernels write into an uninitialised buffer: the caching
    allocator hands them a block just filled with NaN, and the result is
    still bitwise the plain version's (which starts from zeros), on tables
    whose forward steps read entries no step has written yet."""
    s, r, k, nb = 4, 37, 3, 3
    m = s * r
    n_steps = 2 * s if fused else s
    rng = np.random.default_rng(7)
    cols = rng.integers(-m, m + 3, size=(n_steps, r, k))
    dest = step_dest(n_steps, fused)
    c = np.where(cols < 0, cols + m, cols)
    cols = np.where(c // r == dest[:, None, None], m, cols).astype(np.int32)
    t = [torch.tensor(v, device=cuda) for v in (
        cols, 0.3 * rng.normal(size=(n_steps, r, k)),
        rng.uniform(0.5, 1.5, size=(n_steps, r)))]
    q1 = torch.tensor(rng.normal(size=(s, r)), device=cuda)
    qb = torch.tensor(rng.normal(size=(s, r, nb)), device=cuda)
    single, batched, single_ref, batched_ref = (
        (hbmc_trisolve_fused, hbmc_trisolve_fused_batched,
         hbmc_trisolve_fused_ref, hbmc_trisolve_fused_batched_ref)
        if fused else (hbmc_trisolve, hbmc_trisolve_batched,
                       hbmc_trisolve_ref, hbmc_trisolve_batched_ref))
    for fn, ref, q in ((single, single_ref, q1), (batched, batched_ref, qb)):
        junk = torch.full((m,) + tuple(q.shape[2:]), float("nan"),
                          dtype=q.dtype, device=cuda)
        ptr = junk.data_ptr()
        del junk
        z = fn(*t, q)
        assert z.data_ptr() == ptr        # the NaN block was reused
        assert torch.equal(z, ref(*t, q))


# -- the PCG loops as replayed CUDA graphs ------------------------------------

def _embed(plan, b):
    b_bar = np.zeros((plan.n_padded,) + b.shape[1:])
    b_bar[plan._perm] = b
    return plan._embed(b_bar)


def _same(got, want):
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        else:
            assert g == w


@pytest.mark.parametrize("layout", ["round_major", "index"])
def test_replayed_loops_bitwise_eager_on_card(cuda, layout):
    """The three loops replayed as CUDA graphs give the eager block's bits
    at k = 1, 3 and 8, on the signature's first solve (an eager block, the
    capture, replays) and on a warm one (replays only); B = 8 runs B4's
    vector variant, whose pick reads the state's alignment."""
    a = laplace_2d(30, 27)
    plan = build_plan(a, block_size=8, w=4, layout=layout, device=cuda)
    rng = np.random.default_rng(6)
    b = _embed(plan, rng.normal(size=a.shape[0]))
    b8 = _embed(plan, rng.normal(size=(a.shape[0], 8)))
    single = (plan._spmv, plan._precond)
    batched = (plan._spmv_batched, plan._precond.apply_batched)
    for k in (1, 3, 8):
        runs = {
            "single": lambda **kw: _pcg_device(*single, b,
                                               record_history=True, **kw),
            "batched": lambda **kw: _pcg_batched_device(
                *batched, b8, record_history=True, **kw),
            "slab": lambda **kw: _pcg_slab_device(
                *batched, plan.new_slab_state(8)._replace(r=b8.clone()),
                quantum=20, **kw)[0],
        }
        for name, run in runs.items():
            eager = run(steps_per_read=k, eager=True)
            for _ in range(2):
                _same(run(steps_per_read=k, loops=plan._pcg_cache), eager)
    assert plan._capture_count == len(plan._pcg_cache) == 9


def test_capture_count_stays_one_across_warm_solves_and_refactor(cuda):
    a = laplace_2d(30, 27)
    b = np.random.default_rng(7).normal(size=a.shape[0])
    plan = build_plan(a, block_size=8, w=4, device=cuda)
    first = plan.solve(b)
    assert plan._capture_count == 1
    warm = plan.solve(b)
    assert plan._capture_count == 1
    np.testing.assert_array_equal(warm.x, first.x)
    a2 = (a + 0.37 * sp.diags(a.diagonal())).tocsr()
    plan.refactor(a2)
    rep = plan.solve(b)
    assert plan._capture_count == len(plan._pcg_cache) == 1
    cold = build_plan(a2, block_size=8, w=4, device=cuda).solve(b)
    assert rep.result.iterations == cold.result.iterations
    np.testing.assert_array_equal(rep.x, cold.x)


def test_no_collection_runs_during_a_capture(cuda):
    """A plan that died in a reference cycle still holds its graphs until
    the garbage collector frees them, and CUDA forbids destroying a graph
    while a stream captures: the loops capture with the collector off.
    With a collection due at every allocation, none starts while a stream
    captures, and the loop is captured."""
    import gc
    a = laplace_2d(30, 27)
    b = np.random.default_rng(8).normal(size=a.shape[0])
    dead = build_plan(a, block_size=8, w=4, device=cuda)
    dead.solve(b)
    dead.cycle = dead
    del dead
    capturing = []

    def watch(phase, info):
        if phase == "start":
            capturing.append(torch.cuda.is_current_stream_capturing())

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        plan = build_plan(a, block_size=8, w=4, device=cuda)
        rep = plan.solve(b)
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*threshold)
    assert capturing and not any(capturing)
    assert plan._capture_count == 1 and rep.result.status == "CONVERGED"


# ---------------------------------------------------------------------------
# The mesh path: the shard step, sell_spmv_block, a one-rank NCCL mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [None, 3, 8], ids=["single", "B3", "B8"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_shard_step_bitwise_plain_and_per_step_cut(cuda, dtype, nb):
    """The shard step over the whole lane range (lane0 = 0, r_loc = r_full)
    on a NaN-filled y: bitwise its plain version and B1's / B3's per-step
    cut."""
    a, _ = paper_problem("thermal2", scale="tiny")
    plan = build_plan(a, block_size=8, w=4, dtype=dtype, device=cuda)
    t = plan._precond.tables
    rng = np.random.default_rng(12)
    shape = (t.n_steps, t.lanes) + (() if nb is None else (nb,))
    q = torch.tensor(rng.normal(size=shape), device=cuda).to(dtype)
    before = kernels.launch_counts()
    (got,) = shard_apply(t, q, 1)
    name = "hbmc_trisolve_shard_step" + ("" if nb is None else "_batched")
    assert kernels.launch_counts()[name] - before[name] == 2 * t.n_steps
    cpu = [u.cpu() for u in (t.cols, t.vals, t.dinv, q)]
    y = torch.full(got.shape, float("nan"), dtype=dtype)
    for g in range(2 * t.n_steps):
        hbmc_trisolve_shard_step_ref(*cpu, y, g, 0)
    torch.testing.assert_close(got.cpu(), y, rtol=0, atol=0)
    b1 = hbmc_trisolve_fused if nb is None else hbmc_trisolve_fused_batched
    cut = b1(t.cols, t.vals, t.dinv, q, segments=np.arange(2 * t.n_steps))
    torch.testing.assert_close(got, cut, rtol=0, atol=0)


@pytest.mark.parametrize("nb", [None, 8], ids=["single", "B8"])
def test_shard_step_two_way_split_bitwise_b1(cuda, nb):
    """Two lane blocks run in turn on one card, their updates gathered by
    hand after every step: each replica is bitwise B1 / B3 with its
    segments."""
    a = laplace_2d(30, 27)
    plan = build_plan(a, block_size=8, w=4, lane_multiple=2, device=cuda)
    t = plan._precond.tables
    rng = np.random.default_rng(13)
    shape = (t.n_steps, t.lanes) + (() if nb is None else (nb,))
    q = torch.tensor(rng.normal(size=shape), device=cuda)
    b1 = hbmc_trisolve_fused if nb is None else hbmc_trisolve_fused_batched
    want = b1(t.cols, t.vals, t.dinv, q, segments=t.segments)
    for y in shard_apply(t, q, 2):
        torch.testing.assert_close(y, want, rtol=0, atol=0)


@pytest.mark.parametrize("nb", [None, 8], ids=["single", "B8"])
def test_sell_spmv_block_is_rows_of_b2_b4(cuda, nb):
    a = laplace_2d(30, 27)
    plan = build_plan(a, block_size=8, w=4, device=cuda)
    sv, sc = plan._spmv_vals, plan._spmv_cols
    x = torch.tensor(np.random.default_rng(14).normal(
        size=(sv.shape[0] * sv.shape[2],) + (() if nb is None else (nb,))),
        device=cuda)
    lo, hi, w = 3, sv.shape[0] - 2, sv.shape[2]
    kernels.reset_launch_counts()
    got = sell_spmv_block(sv[lo:hi].contiguous(), sc[lo:hi].contiguous(), x)
    assert kernels.launch_counts()["sell_spmv_block"] == 1
    whole = (sell_spmv if nb is None else sell_spmv_batched)(sv, sc, x)
    torch.testing.assert_close(got, whole[lo * w:hi * w], rtol=0, atol=0)


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL group and its ``("data",)`` CUDA mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_plan_bitwise_single_device(nccl_mesh):
    """A mesh plan on one NCCL rank with lane_multiple = 4: solve,
    solve_batched and solve_slab bitwise the single-device plan with the
    same lane_multiple; the shard steps and sell_spmv_block launch, B1 /
    B3 do not."""
    from repro_torch.core import mesh as mesh_mod
    a = laplace_2d(30, 27)
    rng = np.random.default_rng(15)
    b, bb = rng.normal(size=a.shape[0]), rng.normal(size=(a.shape[0], 8))
    kw = dict(block_size=8, w=4, lane_multiple=4)
    ref = build_plan(a, device="cuda", **kw)
    plan = build_plan(a, mesh=nccl_mesh, **kw)
    assert plan.device.type == "cuda" and plan.lane_multiple == 4
    _reset_counts()
    mesh_mod.reset_gather_counts()
    rep = plan.solve(b)
    counts = kernels.launch_counts()
    k, blocks = _blocks(rep.result.iterations)
    assert device_loop.loop_counts()["captures"] == 1    # NCCL in the graph
    applies = 1 + k * blocks
    assert counts == _launched(
        hbmc_trisolve_shard_step=2 * plan.n_rounds * applies,
        sell_spmv=k * blocks, sell_spmv_block=k * blocks)
    assert mesh_mod.gather_counts() == {
        "trisolve": 2 * plan.n_rounds * applies, "spmv": k * blocks}
    want = ref.solve(b)
    assert rep.result.iterations == want.result.iterations
    np.testing.assert_array_equal(rep.x, want.x)
    rb, want_b = plan.solve_batched(bb), ref.solve_batched(bb)
    np.testing.assert_array_equal(rb.result.iterations,
                                  want_b.result.iterations)
    np.testing.assert_array_equal(rb.x, want_b.x)
    rs, want_s = plan.solve_slab(b, 8, slot=5), ref.solve_slab(b, 8, slot=5)
    np.testing.assert_array_equal(rs.x, want_s.x)
    warm = plan.solve(b)
    np.testing.assert_array_equal(warm.x, rep.x)


# ---------------------------------------------------------------------------
# The analysis package on the card: validation, linters, recorded bytes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["round_major", "index"])
def test_validate_on_a_card_plan(cuda, layout):
    """Every mode on a plan whose tables live on the card, the kernel
    checks at B = 1 and 8 and the collective structure (none)."""
    from repro_torch.analysis import (check_plan_collectives,
                                      check_plan_kernels, validate_plan)
    a, _ = paper_problem("g3_circuit", "tiny")
    plan = build_plan(a, method="hbmc", layout=layout, validate="deep",
                      device="cuda")
    for mode in ("off", "cheap", "full", "deep"):
        assert validate_plan(plan, mode) == [], mode
    assert check_plan_kernels(plan, 8) == []
    assert check_plan_collectives(plan) == []
    rep = plan.solve(np.ones(a.shape[0]))
    assert rep.result.status == "CONVERGED"


def test_linters_see_the_kernels_as_opaque_nodes_on_the_card(cuda):
    """A ctypes launch never reaches the dispatcher: the wrappers' marks
    make it one node, so the card's record equals the CPU's."""
    from repro_torch.analysis import (FULL_PALLAS_ITERATION, PALLAS_SPMV,
                                      PRECONDITIONED_ITERATION,
                                      ROUND_MAJOR_APPLY,
                                      check_plan_dtype_flow, lint,
                                      primitive_counts)
    from repro_torch.analysis.dtype_flow import nonzero_rhs
    from repro_torch.core import pcg_iteration
    a = laplace_2d(40, 36)
    recs = {}
    for device in ("cuda", "cpu"):
        plan = build_plan(a, block_size=8, w=4, device=device)
        q = nonzero_rhs(plan)
        plan._precond(q)        # the segments, computed outside the record
        recs[device] = primitive_counts(plan._precond, q)
        assert lint(plan._precond, q, budget=ROUND_MAJOR_APPLY) == []
        assert lint(plan._spmv, q, budget=PALLAS_SPMV) == []
        step = pcg_iteration(plan._spmv, plan._precond)
        args = (torch.zeros_like(q), q, q.clone(),
                torch.ones((), dtype=plan.dtype, device=plan.device))
        for budget in (FULL_PALLAS_ITERATION, PRECONDITIONED_ITERATION):
            assert lint(step, *args, budget=budget,
                        steps=2 * plan.n_rounds) == []
        assert check_plan_dtype_flow(plan) == []

        def leaky(v, pre=plan._precond):
            z = pre(v)
            z[torch.tensor([0], device=v.device)] = 0.0
            return z

        found = lint(leaky, q, budget=ROUND_MAJOR_APPLY)
        assert len(found) == 1 and "aten.index_put_" in found[0]
    assert recs["cuda"]["kernel.hbmc_trisolve_fused"] == 1
    assert recs["cuda"] == recs["cpu"]


def test_wrappers_record_operand_bytes_on_the_card(cuda):
    """Each launch adds its bound's bytes; a replayed graph adds its
    block's, as it adds its launches."""
    from repro_torch.analysis import (check_plan_traffic, spmv_bytes,
                                      trisolve_bytes)
    a = laplace_2d(40, 36)
    plan = build_plan(a, block_size=8, w=4, device="cuda")
    t = plan._precond.tables
    q = torch.ones((t.n_steps, t.lanes), dtype=plan.dtype, device="cuda")
    x = torch.ones(plan.slab_m, dtype=plan.dtype, device="cuda")
    per_apply = trisolve_bytes(t, q)
    per_spmv = spmv_bytes(plan._spmv_vals, plan._spmv_cols, x)
    _reset_counts()
    plan._precond(q.reshape(-1))
    plan._spmv(x)
    seen = kernels.operand_bytes()
    assert seen["hbmc_trisolve_fused"] == per_apply
    assert seen["sell_spmv"] == per_spmv
    assert check_plan_traffic(plan) == []
    _reset_counts()
    plan.solve(np.ones(a.shape[0]))
    counts, seen = kernels.launch_counts(), kernels.operand_bytes()
    assert seen["hbmc_trisolve_fused"] == \
        counts["hbmc_trisolve_fused"] * per_apply
    assert seen["sell_spmv"] == counts["sell_spmv"] * per_spmv


def test_nccl_mesh_plan_validates_and_proves_collectives(nccl_mesh):
    """``validate="full"`` proves a one-rank NCCL mesh plan's whole tables
    and its block; its apply issues 2S all-gathers, its SpMV one, its
    solve no all-reduce (the c10d ops of the dispatch stream included)."""
    from repro_torch.analysis import (check_plan_collectives,
                                      check_plan_kernels)
    plan = build_plan(laplace_2d(30, 27), mesh=nccl_mesh, block_size=8, w=4,
                      lane_multiple=4, validate="full")
    assert check_plan_collectives(plan) == []
    assert check_plan_kernels(plan) == check_plan_kernels(plan, 8) == []


# ---------------------------------------------------------------------------
# the LM stack on the card (PyTorch ops; no kernel of the port)
# ---------------------------------------------------------------------------

def _lm_model_pair(cfg, cuda):
    """One seeded f32 model drawn on the CPU, and its copy on the card."""
    import copy

    from repro_torch.models import init_params
    cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    return cpu, copy.deepcopy(cpu).to(cuda)


def _lm_prompt(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.takes_embeddings:
        return torch.tensor(rng.normal(size=(b, s, cfg.d_model)) * 0.3,
                            dtype=torch.float32)
    return torch.tensor(rng.integers(0, cfg.vocab, size=(b, s)))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b",
                                  "recurrentgemma-2b", "stablelm-12b",
                                  "qwen3-14b", "llama3-405b", "qwen2.5-3b",
                                  "qwen2-vl-72b", "musicgen-medium",
                                  "mamba2-130m"])
def test_lm_smoke_config_on_the_card_matches_the_cpu(cuda, arch):
    """Prefill logits and three teacher-forced decode steps (the CPU's
    greedy tokens), f32, rel 1e-4; the default device is the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.step import prefill, serve_step
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_smoke_config(arch)
    cpu, card = _lm_model_pair(cfg, cuda)
    b, s = 2, 20
    prompt = _lm_prompt(cfg, b, s)
    c_cpu, lg_cpu = prefill(cpu, cfg, prompt, max_len=s + 3,
                            cache_dtype=torch.float32, device="cpu")
    c_card, lg_card = prefill(card, cfg, prompt, max_len=s + 3,
                              cache_dtype=torch.float32)
    assert lg_card.device.type == "cuda"
    assert _rel(lg_card.cpu(), lg_cpu) < 1e-4
    feed = _lm_prompt(cfg, b, 3, seed=2) if cfg.takes_embeddings else None
    tok = None if feed is not None else \
        torch.argmax(lg_cpu[:, -1], -1)[:, None]
    for j in range(3):
        if feed is not None:
            tok = feed[:, j:j + 1]
        a, c_cpu = serve_step(cpu, c_cpu, tok, s + j, cfg=cfg, device="cpu")
        g, c_card = serve_step(card, c_card, tok, s + j, cfg=cfg)
        assert _rel(g.cpu(), a) < 1e-4, j
        if feed is None:
            tok = torch.argmax(a, -1)[:, None]


def test_lm_mamba2_130m_full_forward_on_the_card_matches_the_cpu(cuda):
    """The full config (24 layers, d 768, vocab 50,280) in f32 over a
    300-token prompt: a 256-token SSD chunk and a padded one."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward
    cfg = get_config("mamba2-130m")
    cpu, card = _lm_model_pair(cfg, cuda)
    prompt = _lm_prompt(cfg, 2, 300)
    pos = torch.arange(300)[None].expand(2, 300)
    with torch.no_grad():
        want, _, _ = forward(cpu, cfg, prompt, pos, device="cpu")
        got, _, _ = forward(card, cfg, prompt, pos)
    assert torch.isfinite(got).all()
    assert _rel(got.cpu(), want) < 1e-4


# ---------------------------------------------------------------------------
# LM training on the card (PyTorch ops; no kernel of the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24])
def test_flash_backward_on_the_card_matches_the_cpu(cuda, window):
    """``flash_core``'s dq / dk / dv (two query chunks, two KV chunks), f32,
    rel 1e-5 of the CPU's."""
    from repro_torch.models import flash_vjp
    rng = np.random.default_rng(3)
    q, do = (torch.tensor(rng.normal(size=(2, 128, 2, 4, 32)),
                          dtype=torch.float32) for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(2, 128, 2, 32)),
                         dtype=torch.float32) for _ in range(2))
    pos = torch.arange(128)
    got = []
    for dev in ("cpu", cuda):
        qkv = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = flash_vjp.flash_core(*qkv, pos.to(dev), pos.to(dev), window,
                                   64, 64)
        got.append(torch.autograd.grad(out, qkv, do.to(dev)))
    for want, g in zip(*got):
        assert g.device.type == "cuda"
        assert _rel(g.cpu(), want) < 1e-5


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b",
                                  "qwen2-vl-72b", "mamba2-130m"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One ``train_step`` of a smoke config from the same f32 weights (drawn
    on the CPU): loss and grad norm rel 1e-4, and the new parameters within
    2 lr of the CPU's (Adam's first step is about lr * sign(g), so a
    gradient near 0 may take the other sign) and within 1e-4 x max(1,
    max|p|) on 99% of each leaf's entries."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import (DataConfig, sample_batch,
                                           sample_embedding_batch)
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import train_step
    cfg = get_smoke_config(arch)
    cpu, card = _lm_model_pair(cfg, cuda)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=4)
    bt = (sample_embedding_batch(dcfg, 0, cfg.d_model)
          if cfg.takes_embeddings else sample_batch(dcfg, 0))
    lr = 1e-3
    ocfg = AdamWConfig(lr=lr, total_steps=10, warmup_steps=1)
    _, m_cpu = train_step(cpu, init_opt_state(cpu), bt, cfg=cfg,
                          opt_cfg=ocfg, device="cpu")
    _, m_card = train_step(card, init_opt_state(card), bt, cfg=cfg,
                           opt_cfg=ocfg)
    assert m_card["loss"].device.type == "cuda"
    for key in ("loss", "grad_norm"):
        assert abs(float(m_card[key]) / float(m_cpu[key]) - 1) < 1e-4, key
    for (name, a), b in zip(cpu.named_parameters(), card.parameters()):
        a = a.detach()
        d = (b.detach().cpu() - a).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, name
        tight = d <= 1e-4 * max(1.0, float(a.abs().max()))
        assert float(tight.float().mean()) >= 0.99, name


@pytest.fixture
def nccl_lm_mesh(cuda, tmp_path):
    """A one-rank NCCL group and its (1, 1) ``("data", "model")`` CUDA
    mesh (``launch.mesh.make_host_mesh``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x22b",
                                  "mamba2-130m", "qwen2-vl-72b"])
def test_sharded_train_step_on_the_card_matches_unsharded(cuda, nccl_lm_mesh,
                                                          arch):
    """One ``train_step`` of a smoke config (f32) with its parameters and
    batch placed on the (1, 1) NCCL mesh against the card's unsharded step
    from the same weights: gradients per leaf within 1e-4 x max(1,
    max|g|), loss and grad norm rel 1e-4, the new parameters as in
    ``test_train_step_on_the_card_matches_the_cpu`` (within 2 lr, and 1e-4
    x max(1, max|p|) on 99% of each leaf); the MoE arch took the explicit
    dispatch."""
    from torch.distributed.tensor import DTensor

    from repro_torch import dist as D
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, sample_batch
    from repro_torch.models import moe_shardmap
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import loss_fn, train_step
    mesh = nccl_lm_mesh
    cfg = get_smoke_config(arch)
    _, card = _lm_model_pair(cfg, cuda)
    sharded = D.distribute_params(_lm_model_pair(cfg, cuda)[1],
                                  D.params_shardings(card, mesh))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=4)
    bt = {k: torch.as_tensor(v, device=cuda)
          for k, v in sample_batch(dcfg, 0).items()}
    bt_s = {k: D.distribute(v, D.NamedSharding(mesh, D.batch_partition_spec(
        mesh, v.shape[0], v.ndim))) for k, v in bt.items()}
    ocfg = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)

    def grads(model, batch):
        total, m = loss_fn(model, cfg, batch["inputs"],
                           batch["labels"].long())
        names, params = zip(*model.named_parameters())
        return m, dict(zip(names, torch.autograd.grad(total, params,
                                                      allow_unused=True)))
    _, g_plain = grads(card, bt)
    moe_shardmap.reset_engaged_count()
    with D.use_mesh(mesh):
        _, g_sh = grads(sharded, bt_s)
        _, m_sh = train_step(sharded, init_opt_state(sharded), bt_s, cfg=cfg,
                             opt_cfg=ocfg)
    assert (moe_shardmap.engaged_count() > 0) == (cfg.n_experts > 0)
    _, m_plain = train_step(card, init_opt_state(card), bt, cfg=cfg,
                            opt_cfg=ocfg)
    for name, want in g_plain.items():
        if want is None:
            assert g_sh[name] is None, name
            continue
        got = g_sh[name]
        assert isinstance(got, DTensor)
        err = float((got.full_tensor() - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), name
    for key in ("loss", "grad_norm"):
        assert abs(float(m_sh[key]) / float(m_plain[key]) - 1) < 1e-4, key
    for (name, a), b in zip(card.named_parameters(), sharded.parameters()):
        d = (b.full_tensor() - a).abs()
        assert float(d.max()) <= 2 * 1e-3 + 1e-6, name
        tight = d <= 1e-4 * max(1.0, float(a.abs().max()))
        assert float(tight.float().mean()) >= 0.99, name


def test_sharded_moe_on_the_card_matches_moe_apply(cuda, nccl_lm_mesh):
    """``moe_apply_shardmap`` on the (1, 1) NCCL mesh against
    ``moe_apply`` on the card, exact capacity and the 1.25 factor: outputs
    and every gradient within 1e-5 x max(1, max|want|)."""
    import _torch_lm_mesh_worker as worker

    from repro_torch import dist as D
    from repro_torch.models import moe_shardmap
    from repro_torch.models.moe import moe_apply
    mesh = nccl_lm_mesh
    mi = worker.moe_inputs()
    for cf in (0.0, 1.25):
        kw = dict(top_k=worker.MOE["top_k"], capacity_factor=cf, act="silu")
        m = worker.moe_module(mi).to(cuda)
        x = torch.tensor(mi["x"], device=cuda, requires_grad=True)
        want = _moe_grads_on(m, x, moe_apply(m, x, **kw), mi)
        D.distribute_params(m, {n: D.NamedSharding(mesh, D.param_partition_spec(
            n, p, mesh)) for n, p in m.named_parameters()})
        xd = D.distribute(x.detach(), D.NamedSharding(
            mesh, D.batch_partition_spec(mesh, x.shape[0], 3)))
        xd.requires_grad_(True)
        moe_shardmap.reset_engaged_count()
        with D.use_mesh(mesh):
            got = _moe_grads_on(m, xd, moe_shardmap.moe_apply_shardmap(
                m, xd, **kw), mi)
        assert moe_shardmap.engaged_count() == 1
        for k, w in want.items():
            err = float((got[k] - w).abs().max())
            assert err <= 1e-5 * max(1.0, float(w.abs().max())), (cf, k)


def _moe_grads_on(m, x, res, mi):
    """y, the logits and the gradients of <y, gy> + <logits, glogits> on
    the card, as whole tensors."""
    from torch.distributed.tensor import DTensor
    y, logits = res
    dev = next(m.parameters()).device
    gy = torch.tensor(mi["gy"], device=dev)
    gl = torch.tensor(mi["glogits"], device=dev)
    total = (y * gy).sum() + (logits * gl).sum()
    names, params = zip(*m.named_parameters())
    gs = torch.autograd.grad(total, (x,) + params)

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()
    out = {"y": whole(y), "logits": whole(logits), "x": whole(gs[0])}
    out.update({n: whole(g) for n, g in zip(names, gs[1:])})
    return out
