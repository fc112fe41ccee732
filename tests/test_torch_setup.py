"""Host-side setup of the PyTorch port against the JAX reference.

The port keeps its own numpy/scipy copies of the setup modules (importing
the reference package loads JAX), so every setup product must be
bitwise-equal to the reference's: permutation, padded system, rounds for
both schedulers, IC(0) factor and clamp count, fused round-major tables and
layout, and the SELL-w operand -- on the five paper generators, and on a
sweep of random ``graph_laplacian`` graphs (seeds, sizes, degrees) and
non-square ``laplace_2d`` grids.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import repro.core.plan as j_plan
import repro.core.sell as j_sell
import repro_torch.core.plan as t_plan
import repro_torch.core.sell as t_sell
from repro.core.ic0 import FactorBreakdownError as JFactorBreakdownError
from repro.core.ic0 import ic0_refactor as j_ic0_refactor
from repro.core.ic0 import ic0_structure as j_ic0_structure
from repro.core import build_plan as j_build_plan
from repro.core import matrices as j_matrices
from repro.core.matrices import PAPER_PROBLEMS, PAPER_SHIFTS, paper_problem
from repro.serve.faults import indefinite_matrix
from repro_torch.core import build_plan as t_build_plan
from repro_torch.core import matrices as t_matrices
from repro_torch.core.ic0 import FactorBreakdownError as TFactorBreakdownError
from repro_torch.core.ic0 import ic0_refactor as t_ic0_refactor
from repro_torch.core.ic0 import ic0_structure as t_ic0_structure

BS, W = 8, 4


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _csr_eq(a, b, what):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape, what
    _eq(a.indptr, b.indptr, what + ".indptr")
    _eq(a.indices, b.indices, what + ".indices")
    _eq(a.data, b.data, what + ".data")


def _rounds_eq(ra, rb, what):
    assert len(ra) == len(rb), what
    for s, (x, y) in enumerate(zip(ra, rb)):
        _eq(x, y, f"{what}[{s}]")


@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_generators_bitwise(name):
    a_j, desc_j = paper_problem(name, scale="tiny")
    a_t, desc_t = t_matrices.paper_problem(name, scale="tiny")
    assert desc_j == desc_t
    _csr_eq(a_j, a_t, name)
    assert t_matrices.PAPER_SHIFTS == PAPER_SHIFTS
    assert t_matrices.PAPER_PROBLEMS == PAPER_PROBLEMS


@pytest.mark.parametrize("scheduler", ["coloring", "levelset"])
@pytest.mark.parametrize("method", ["mc", "bmc", "hbmc"])
@pytest.mark.parametrize("name", PAPER_PROBLEMS)
def test_setup_pipeline_bitwise(name, method, scheduler):
    a, _ = paper_problem(name, scale="tiny")
    _pipeline_bitwise(a, method, scheduler, PAPER_SHIFTS.get(name, 0.0))


#: the random and non-square sweep: (generator, its arguments)
SWEEP = [("graph_laplacian", (150, 3, 1)), ("graph_laplacian", (300, 4, 2)),
         ("graph_laplacian", (257, 6, 3)), ("graph_laplacian", (97, 2, 7)),
         ("laplace_2d", (13, 11)), ("laplace_2d", (5, 17)),
         ("laplace_2d", (24, 7))]


@pytest.mark.parametrize("method", ["mc", "bmc", "hbmc"])
@pytest.mark.parametrize("gen, args", SWEEP,
                         ids=[f"{g}{a}" for g, a in SWEEP])
def test_setup_sweep_bitwise(gen, args, method):
    """Orderings, rounds, factor and packed tables of random graphs and
    non-square grids, bitwise the reference's."""
    a = getattr(j_matrices, gen)(*args)
    _csr_eq(a, getattr(t_matrices, gen)(*args), f"{gen}{args}")
    _pipeline_bitwise(a, method, "coloring", 0.0)


def _pipeline_bitwise(a, method: str, scheduler: str, shift: float):
    a = sp.csr_matrix(a)
    a.sort_indices()
    sj = j_plan._order_system(a, None, method, BS, W, scheduler=scheduler)
    st = t_plan._order_system(a, None, method, BS, W, scheduler=scheduler)
    _eq(sj.perm, st.perm, "perm")
    assert (sj.n, sj.n_padded, sj.n_colors) == (st.n, st.n_padded,
                                                st.n_colors)
    _csr_eq(sj.a_bar, st.a_bar, "a_bar")
    _rounds_eq(sj.fwd_rounds, st.fwd_rounds, "fwd_rounds")
    _rounds_eq(sj.bwd_rounds, st.bwd_rounds, "bwd_rounds")
    if sj.drop is None:
        assert st.drop is None
    else:
        _eq(sj.drop, st.drop, "drop")

    lj = j_ic0_refactor(j_ic0_structure(sj.a_bar, sj.fwd_rounds), sj.a_bar,
                        shift=shift)
    lt = t_ic0_refactor(t_ic0_structure(st.a_bar, st.fwd_rounds), st.a_bar,
                        shift=shift)
    _csr_eq(lj, lt, "L")
    assert lj.clamped_pivots == lt.clamped_pivots

    fj = j_sell.fuse_round_major(*j_sell.pack_factor(
        lj, sj.fwd_rounds, sj.bwd_rounds, sj.drop))
    ft = t_sell.fuse_round_major(*t_sell.pack_factor(
        lt, st.fwd_rounds, st.bwd_rounds, st.drop))
    for field in ("cols", "vals", "dinv"):
        _eq(getattr(fj, field), getattr(ft, field), "fused." + field)
    _eq(fj.layout.rows, ft.layout.rows, "layout.rows")
    _eq(fj.layout.pos, ft.layout.pos, "layout.pos")
    assert fj.layout.n_slots == ft.layout.n_slots

    mj = j_sell.pack_sell(j_sell.permute_round_major(sj.a_bar, fj.layout), W)
    mt = t_sell.pack_sell(t_sell.permute_round_major(st.a_bar, ft.layout), W)
    for field in ("cols", "vals", "slice_k"):
        _eq(getattr(mj, field), getattr(mt, field), "sell." + field)
    assert (mj.n, mj.w, mj.padded_nnz, mj.nnz) == (mt.n, mt.w,
                                                   mt.padded_nnz, mt.nnz)


@pytest.mark.parametrize("method", ["hbmc", "mc"])
@pytest.mark.parametrize("name", ["thermal2", "ieej"])
def test_plan_operands_bitwise(name, method):
    """The plans' device operands, as built by build_plan on each side."""
    a, _ = paper_problem(name, scale="tiny")
    kw = dict(method=method, block_size=BS, w=W,
              shift=PAPER_SHIFTS.get(name, 0.0))
    jp = j_build_plan(a, spmv_format="sell", **kw)
    tp = t_build_plan(a, device="cpu", **kw)
    jt, tt = jp._precond.tables, tp._precond.tables
    _eq(np.asarray(jt.cols), tt.cols.numpy(), "cols")
    _eq(np.asarray(jt.vals), tt.vals.numpy(), "vals")
    _eq(np.asarray(jt.dinv), tt.dinv.numpy(), "dinv")
    _eq(np.asarray(jp._spmv_vals), tp._spmv_vals.numpy(), "sell vals")
    _eq(np.asarray(jp._spmv_cols), tp._spmv_cols.numpy(), "sell cols")
    assert jp._spmv_n == tp._spmv_n
    assert (jp.n, jp.n_padded, jp.n_colors, jp.n_rounds) == (
        tp.n, tp.n_padded, tp.n_colors, tp.n_rounds)
    assert jp.lane_occupancy == tp.lane_occupancy
    assert jp.clamped_pivots == tp.clamped_pivots


@pytest.mark.parametrize("on_breakdown", ["clamp", "escalate"])
def test_breakdown_policy_records_match(on_breakdown):
    a = indefinite_matrix(6)
    kw = dict(method="hbmc", block_size=BS, w=W, on_breakdown=on_breakdown)
    jp = j_build_plan(a, **kw)
    tp = t_build_plan(a, device="cpu", **kw)
    assert tp.clamped_pivots == jp.clamped_pivots
    assert tp.shift_schedule == jp.shift_schedule
    assert tp.effective_shift == jp.effective_shift


def test_breakdown_policy_raise_matches():
    a = indefinite_matrix(6)
    kw = dict(method="hbmc", block_size=BS, w=W, on_breakdown="raise")
    with pytest.raises(JFactorBreakdownError) as ej:
        j_build_plan(a, **kw)
    with pytest.raises(TFactorBreakdownError) as et:
        t_build_plan(a, device="cpu", **kw)
    assert str(ej.value) == str(et.value)
    assert ej.value.clamped_pivots == et.value.clamped_pivots
    assert ej.value.shift_schedule == et.value.shift_schedule


BAD_ARGS = [dict(block_size=0), dict(block_size=-3), dict(block_size=2.5),
            dict(block_size=True), dict(w=0), dict(w=-1), dict(w=4.0),
            dict(w=False), dict(on_breakdown="explode"),
            dict(scheduler="fastest")]


@pytest.mark.parametrize("bad", BAD_ARGS, ids=lambda d: repr(d))
def test_entry_point_value_errors_match(bad):
    a = t_matrices.laplace_2d(6, 6)
    kw = dict(method="hbmc", block_size=BS, w=W)
    kw.update(bad)
    with pytest.raises(ValueError) as ej:
        j_build_plan(a, **kw)
    with pytest.raises(ValueError) as et:
        t_build_plan(a, device="cpu", **kw)
    assert str(ej.value) == str(et.value)


def test_unknown_method_raises():
    a = t_matrices.laplace_2d(6, 6)
    with pytest.raises(ValueError, match="unknown method"):
        t_build_plan(a, method="rainbow", device="cpu")
