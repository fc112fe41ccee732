"""The port's device-resident PCG loops (``core.device_loop``) on the CPU.

Each loop runs blocks of ``k`` masked steps and reads one flag per block;
on the CPU the blocks run eagerly on the same schedule as the card's
replayed graphs.  Inputs are made by numpy from a seed.

* Against the reference: for k in {1, 3, 8}, ``_pcg_device``,
  ``_pcg_batched_device`` and ``_pcg_slab_device`` give the JAX package's
  iteration counts, statuses, trips and ``record_history`` histories, on
  the five paper generators at ``scale="tiny"`` (the settings of
  ``tests/test_paper_semantics.py``) and on six fault inputs: a NaN RHS, a
  zero RHS, a non-SPD operator (BREAKDOWN, rolled back to the last finite
  iterate), ``maxiter=5`` (MAXITER), a small ``stagnation_window``
  (STAGNATED) and a small ``divergence_factor`` (DIVERGED).  Counts,
  statuses and trips exact; histories within rtol 1e-6 on the paper plans
  and 1e-9 on the dense operators: the two packages sum dots and norms in
  other orders, and on the ill-conditioned ``ieej`` plan that drift
  reaches 1e-7 of the residual by its last iterations.
* Across k: every result bitwise equal to the k = 1 run.
* Serving: a ``SolverService`` at quantum 1, 5 and 16 serves every request
  bitwise ``plan.solve_slab``, with the same dispatch ``steps`` and bits
  at every k.
* The cache: one loop per signature, none added by a warm solve or by
  ``refactor``, which writes the new values into the tensors the loops
  read; the refactored solve is bitwise a cold plan's.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import build_plan as j_build_plan
from repro.core.iccg import _pcg_batched_device as j_pcg_batched_device
from repro.core.iccg import _pcg_device as j_pcg_device
from repro.core.matrices import PAPER_PROBLEMS, PAPER_SHIFTS, laplace_2d
from repro.core.matrices import paper_problem
from repro.serve.faults import near_singular_matrix
from repro_torch.core import SlabState, build_plan, device_loop
from repro_torch.core.device_loop import BlockLoop, LoopCache
from repro_torch.core.iccg import (STATUS_NAMES, _pcg_batched_device,
                                   _pcg_device, _pcg_slab_device)
from repro_torch.serve import SolverService, VirtualClock

KS = (1, 3, 8)
KNOBS = dict(method="hbmc", block_size=8, w=4, spmv_format="sell")
FAULTS = ("nan", "zero", "indefinite", "maxiter", "stagnated", "diverged")
WIDTH = 3


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Cases: operators, right-hand sides and knobs for both packages.
# ---------------------------------------------------------------------------

@functools.cache
def _paper_plans(name):
    a, _ = paper_problem(name, scale="tiny")
    shift = PAPER_SHIFTS.get(name, 0.0)
    return (build_plan(a, shift=shift, device="cpu", **KNOBS),
            j_build_plan(a, shift=shift, **KNOBS))


@functools.cache
def _fault_case(case):
    """(dense operator, (n, WIDTH) right-hand sides, loop knobs): column 0
    carries the fault, the others are healthy neighbours."""
    kw = dict(record_history=True)
    if case == "indefinite":
        a = np.diag(np.linspace(-3.0, 10.0, 16))
    elif case == "diverged":
        a = np.diag(np.linspace(1.0, 10.0, 16))
        kw["divergence_factor"] = 1e-6
    elif case == "stagnated":
        a = near_singular_matrix(6).toarray()
        kw.update(rtol=1e-14, maxiter=5000, stagnation_window=10)
    else:
        # a spread spectrum: CG converges gradually, so rounding stays
        # small to the last step
        a = np.diag(np.linspace(1.0, 100.0, 40))
        if case == "maxiter":
            kw["maxiter"] = 5
    n = a.shape[0]
    b = np.stack([_rhs(n, 7 + j) for j in range(WIDTH)], axis=1)
    if case == "nan":
        b[3, 0] = np.nan
    elif case == "zero":
        b[:, 0] = 0.0
    elif case == "stagnated":
        # right-hand sides that stall early (test_torch_batched): one that
        # stalls later gives rounding-set counts at this rtol
        b[:, 1] = _rhs(n, 10)
        b[:, 2] = b[:, 0]
    return a, b, kw


def _operators(case):
    """The port's and the reference's (spmv, precond, b (n, WIDTH), knobs)
    for one case; the paper plans' right-hand sides are seeded as in
    ``test_paper_semantics`` (column 0 is its seed-7 vector)."""
    if case in FAULTS:
        a, b, kw = _fault_case(case)
        ta, ja = torch.from_numpy(a), jnp.asarray(a)
        return ((lambda v: ta @ v, lambda v: v, torch.from_numpy(b)),
                (lambda v: ja @ v, lambda v: v, jnp.asarray(b)), kw)
    plan, jplan = _paper_plans(case)
    b = np.stack([np.random.default_rng(7).normal(size=plan.n)]
                 + [_rhs(plan.n, 8 + j) for j in range(WIDTH - 1)], axis=1)
    b_bar = np.zeros((plan.n_padded, WIDTH))
    b_bar[plan._perm] = b
    return ((plan._spmv_batched, plan._precond.apply_batched,
             plan._embed(b_bar), plan._spmv, plan._precond),
            (jplan, b), dict(record_history=True))


def _single_ops(port):
    """The port's single-RHS (spmv, precond) of a case."""
    return (port[3], port[4]) if len(port) == 5 else port[:2]


@functools.cache
def _port_run(case, k):
    """Every loop of the port on a case at k steps per read, as numpy."""
    port, _, kw = _operators(case)
    spmv_b, pre_b, b = port[:3]
    spmv, pre = _single_ops(port)
    single = [_pcg_device(spmv, pre, b[:, j].contiguous(), steps_per_read=k,
                          **kw) for j in range(WIDTH)]
    xb, iters, relres, n_steps, status, hist = _pcg_batched_device(
        spmv_b, pre_b, b, steps_per_read=k, **kw)
    slab = _run_slab(spmv_b, pre_b, b, k, kw)
    return dict(
        single=[tuple(_np(t) for t in res) for res in single],
        batched=(_np(xb), _np(iters), _np(relres), n_steps, _np(status),
                 _np(hist)),
        slab=slab)


def _run_slab(spmv, precond, b, k, kw, quantum=5):
    """All columns through the slab loop in dispatches of ``quantum``."""
    kw = {key: v for key, v in kw.items() if key != "record_history"}
    m, nb = b.shape
    state = SlabState(
        x=torch.zeros_like(b), r=b.clone(), p=torch.zeros_like(b),
        rz=torch.zeros(nb, dtype=b.dtype), bnorm=torch.ones(nb,
                                                            dtype=b.dtype),
        active=torch.zeros(nb, dtype=torch.bool),
        iters=torch.zeros(nb, dtype=torch.int32),
        relres=torch.zeros(nb, dtype=b.dtype),
        fresh=torch.ones(nb, dtype=torch.bool),
        status=torch.zeros(nb, dtype=torch.int32),
        best=torch.zeros(nb, dtype=b.dtype),
        since_best=torch.zeros(nb, dtype=torch.int32))
    steps = []
    while True:
        state, s = _pcg_slab_device(spmv, precond, state, quantum=quantum,
                                    steps_per_read=k, **kw)
        steps.append(s)
        if not bool(state.active.any()):
            break
    return tuple(_np(t) for t in state), tuple(steps)


@functools.cache
def _jax_run(case):
    """The reference's single-RHS and batched loops on the same case."""
    _, ref, kw = _operators(case)
    if case in FAULTS:
        spmv, pre, b = ref
        single = [tuple(np.asarray(t) for t in j_pcg_device(
            spmv, pre, b[:, j], **kw)) for j in range(WIDTH)]
        batched = tuple(np.asarray(t) for t in j_pcg_batched_device(
            spmv, pre, b, **kw))
        return single, batched
    jplan, b = ref
    single = []
    for j in range(WIDTH):
        r = jplan.solve(b[:, j], record_history=True).result
        single.append((r.x, r.iterations, r.relres,
                       STATUS_NAMES.index(r.status), r.history))
    r = jplan.solve_batched(b, record_history=True).result
    return single, (r.x, r.iterations, r.relres, r.n_steps, r.status,
                    r.history)


# ---------------------------------------------------------------------------
# Against the reference, at every k.
# ---------------------------------------------------------------------------

def _history_close(got, want, rtol):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", PAPER_PROBLEMS + FAULTS)
def test_loops_match_jax(case, k):
    port, (jsingle, jbatched) = _port_run(case, k), _jax_run(case)
    rtol = 1e-9 if case in FAULTS else 1e-6
    for j, (got, want) in enumerate(zip(port["single"], jsingle)):
        x, it, relres, status, hist = got
        assert (int(it), STATUS_NAMES[int(status)]) == (
            int(want[1]), STATUS_NAMES[int(want[3])]), (case, j)
        _history_close(hist, np.asarray(want[4]), rtol)
        assert np.isfinite(x).all()
    x, iters, relres, n_steps, status, hist = port["batched"]
    np.testing.assert_array_equal(iters, jbatched[1])
    np.testing.assert_array_equal(status, jbatched[4])
    assert n_steps == int(jbatched[3])
    _history_close(hist, np.asarray(jbatched[5]), rtol)
    # per-column counts: the batched loop's, the single-RHS loop's and the
    # slab loop's alike
    (slab, _) = port["slab"]
    np.testing.assert_array_equal(iters, [int(s[1]) for s in port["single"]])
    np.testing.assert_array_equal(slab[6], iters)
    np.testing.assert_array_equal(slab[9], status)
    if case in FAULTS:
        want = {"nan": "BREAKDOWN", "zero": "CONVERGED",
                "indefinite": "BREAKDOWN", "maxiter": "MAXITER",
                "stagnated": "STAGNATED", "diverged": "DIVERGED"}[case]
        assert STATUS_NAMES[int(status[0])] == want
        if case in ("indefinite", "diverged"):
            # diagonal operators: the rollback to the last finite iterate
            # and the stopped iterate agree with the reference's
            np.testing.assert_allclose(port["single"][0][0],
                                       np.asarray(jsingle[0][0]),
                                       rtol=1e-9, atol=1e-9)
    else:
        assert STATUS_NAMES[int(status[0])] == "CONVERGED"


@pytest.mark.parametrize("k", KS[1:])
@pytest.mark.parametrize("case", PAPER_PROBLEMS + FAULTS)
def test_results_bitwise_across_k(case, k):
    got, want = _port_run(case, k), _port_run(case, 1)
    for g, w in zip(got["single"], want["single"]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got["batched"], want["batched"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["slab"][0], want["slab"][0]):
        np.testing.assert_array_equal(a, b)
    assert got["slab"][1] == want["slab"][1]     # trips per dispatch


def test_non_spd_rolls_back_to_the_last_finite_iterate():
    """The indefinite operator breaks down at step it + 1: the reported x
    is the iterate of step it, bitwise the one a run capped there gives."""
    (spmv, pre, b), _, kw = _operators("indefinite")
    for k in KS:
        x, it, _, status, _ = _pcg_device(spmv, pre, b[:, 0].contiguous(),
                                          steps_per_read=k)
        assert STATUS_NAMES[int(status)] == "BREAKDOWN"
        capped = _pcg_device(spmv, pre, b[:, 0].contiguous(),
                             maxiter=int(it), steps_per_read=k)
        assert STATUS_NAMES[int(capped[3])] == "MAXITER"
        torch.testing.assert_close(x, capped[0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The read-every-k schedule.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
def test_one_read_per_block(k):
    plan = build_plan(laplace_2d(12, 10), device="cpu", **KNOBS)
    b = _rhs(plan.n, 3)
    for rhs, eager in ((b, False), (b, True), (np.zeros(plan.n), False)):
        device_loop.reset_loop_counts()
        b_bar = np.zeros(plan.n_padded)
        b_bar[plan._perm] = rhs
        _, it, _, _, _ = _pcg_device(plan._spmv, plan._precond,
                                     plan._embed(b_bar), steps_per_read=k,
                                     eager=eager)
        blocks = math.ceil(int(it) / k)
        assert device_loop.loop_counts() == dict(
            reads=blocks + 1, blocks=blocks, replays=0, captures=0)
    assert int(it) == 0 and blocks == 0


def test_block_loop_rejects_no_steps():
    with pytest.raises(ValueError, match="steps_per_read"):
        BlockLoop(0)
    assert len(LoopCache()) == 0


# ---------------------------------------------------------------------------
# Serving at every quantum and k.
# ---------------------------------------------------------------------------

def _serve(quantum, k, monkeypatch):
    monkeypatch.setattr(device_loop, "_STEPS_PER_READ", k)
    a = laplace_2d(9, 8)
    rng = np.random.default_rng(quantum)
    bs = [rng.standard_normal(a.shape[0]) for _ in range(7)]
    bs[2][4] = np.nan
    bs[5][:] = 0.0
    svc = SolverService(slab_width=4, quantum=quantum, clock=VirtualClock(),
                        record_dispatches=True, device="cpu", method="hbmc",
                        block_size=8, w=4)
    rids = [svc.submit(a, b, arrival_time=0.01 * i)
            for i, b in enumerate(bs)]
    svc.drain()
    plan, status = svc.cache.get(a, device="cpu", method="hbmc",
                                 block_size=8, w=4)
    assert status == "hit"
    done = [svc.completed[r] for r in rids]
    for b, c in zip(bs, done):
        if c.x is not None:
            np.testing.assert_array_equal(
                c.x, plan.solve_slab(b, slab_width=4, slot=c.slot).x)
    return done, [e["steps"] for e in svc.dispatch_log]


@pytest.mark.parametrize("quantum", [1, 5, 16])
def test_service_bitwise_solve_slab_at_every_k(quantum, monkeypatch):
    done1, steps1 = _serve(quantum, 1, monkeypatch)
    assert [c.status for c in done1] == (["CONVERGED"] * 2 + ["BREAKDOWN"]
                                         + ["CONVERGED"] * 4)
    assert done1[5].iterations == 0
    assert max(steps1) <= quantum
    for k in KS[1:]:
        done, steps = _serve(quantum, k, monkeypatch)
        assert steps == steps1, k
        for c, c1 in zip(done, done1):
            assert (c.status, c.iterations, c.slot) == (c1.status,
                                                        c1.iterations,
                                                        c1.slot)
            if c1.x is not None:
                np.testing.assert_array_equal(c.x, c1.x)


# ---------------------------------------------------------------------------
# The plan's cache (the reference's test_refactor_does_not_retrace_pcg).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["round_major", "index"])
def test_refactor_adds_no_loop_and_writes_in_place(layout):
    a = laplace_2d(12, 10)
    b = _rhs(a.shape[0], 9)
    knobs = dict(KNOBS, layout=layout, device="cpu")
    plan = build_plan(a, **knobs)
    plan.solve(b)
    keys = list(plan._pcg_cache.keys())
    assert keys == [("single", 1e-7, 10_000, False, 1e8, 1000,
                     device_loop._STEPS_PER_READ, None)]
    loop = plan._pcg_cache.get(keys[0], device_loop._STEPS_PER_READ)
    plan.solve(b)
    assert len(plan._pcg_cache) == 1          # warm solve: no new loop
    operands = [plan._spmv_vals, plan._spmv_cols] + [
        t for tab in plan._step_tables() for t in (tab.vals, tab.dinv)]
    a2 = (a + 0.2 * sp.diags(a.diagonal())).tocsr()
    plan.refactor(a2)
    rep = plan.solve(b)
    assert list(plan._pcg_cache.keys()) == keys
    assert plan._pcg_cache.get(keys[0], device_loop._STEPS_PER_READ) is loop
    after = [plan._spmv_vals, plan._spmv_cols] + [
        t for tab in plan._step_tables() for t in (tab.vals, tab.dinv)]
    assert all(t is u for t, u in zip(operands, after))   # in place
    assert plan._capture_count == 0          # no graph on the CPU
    cold = build_plan(a2, **knobs).solve(b)
    assert rep.result.iterations == cold.result.iterations
    np.testing.assert_array_equal(rep.x, cold.x)
    # one loop per signature
    plan.solve_batched(np.stack([b, b], axis=1))
    plan.solve_slab(b, slab_width=2)
    plan.solve(b, rtol=1e-6)
    assert sorted(k[0] for k in plan._pcg_cache.keys()) == [
        "batched", "single", "single", "slab"]
