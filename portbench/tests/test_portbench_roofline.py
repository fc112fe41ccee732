"""The roofline byte counts against a hand count on a small matrix, and the
trace readers on a hand-made trace."""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
from conftest import spec

from portbench.lib import roofline
from portbench.lib.harness import Request, Run
from portbench.lib.peaks import HBM_BYTES_PER_S
from portbench.lib.trace import DeviceTrace


def _grid3():
    """3 x 3 inner nodes of the triangular lattice: 9 rows, 6 east, 6 north
    and 4 north-west edges, so nnz = 9 + 2 x 16 = 41 and the strict lower
    triangle holds 16."""
    fam = spec.load_module("matrices", "fem2d_p1_lognormal")
    return fam.assemble(3, 3, np.ones((2, 4, 4)))


def _run(**kw) -> Run:
    import torch
    run = Run(workload="t", config={}, traffic={}, seed=0, seconds=1.0,
              traced=True, device=torch.device("cpu"), t_process=0.0)
    run.facts.update(n=9, nnz=41, nnz_lower=16, slab_width=8)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_grid_counts():
    a = _grid3()
    assert a.shape == (9, 9) and a.nnz == 41
    assert sp.tril(a, k=-1).nnz == 16


@pytest.mark.parametrize("b", [1, 8])
def test_byte_counts_by_hand(b):
    # 16 L entries x (8 + 4) + 9 diagonal x 8 + 9 x B x (8 in + 8 out)
    assert roofline.apply_bytes(9, 16, b) == 192 + 72 + 144 * b
    # 41 entries x (8 + 4) + 9 x B x (8 in + 8 out)
    assert roofline.spmv_bytes(9, 41, b) == 492 + 144 * b


TRACE = DeviceTrace(
    window=(0.0, 100.0),
    device=[(0.0, 10.0, "void segment_single<double, true>(int const*)"),
            (5.0, 12.0, "void sell_spmv_kernel<double>(double const*)"),
            (20.0, 30.0, "void at::native::reduce_kernel<512, 1>()"),
            (40.0, 42.0, "Memcpy DtoH (Device -> Pageable)"),
            (50.0, 58.0, "void fused_segment_batched<double>()")],
    host_ranges=[(0.0, 60.0, "solve")], host_ops=[])


def test_solve_readers_on_a_hand_trace():
    run = _run(device_trace=TRACE,
               requests=[Request(0, 0.0, 1.0, 4, "CONVERGED"),
                         Request(1, 1.0, 2.0, 6, "CONVERGED")])
    tri = spec.load_module("metrics", "trisolve_roofline.solve")
    want = 100 * 12 * roofline.apply_bytes(9, 16, 1) / HBM_BYTES_PER_S / 18e-6
    assert tri.read(run) == pytest.approx(want)
    spmv = spec.load_module("metrics", "spmv_roofline.solve")
    want = 100 * 10 * roofline.spmv_bytes(9, 41, 1) / HBM_BYTES_PER_S / 7e-6
    assert spmv.read(run) == pytest.approx(want)
    vec = spec.load_module("metrics", "vector_ms_per_iter.solve")
    assert vec.read(run) == pytest.approx(1e3 * 10e-6 / 10)
    idle = spec.load_module("metrics", "idle_share.solve")
    # busy: [0, 12] + [20, 30] + [40, 42] + [50, 58] = 32 of 100 us
    assert idle.read(run) == pytest.approx(68.0)
    assert spec.load_module("metrics", "iters.solve").read(run) == 5.0


def test_service_readers_on_a_hand_dispatch_log():
    log = [{"rids": [0, 1, None, None, None, None, None, None], "steps": 3},
           {"rids": [0, 1, 2, 3, None, None, None, None], "steps": 1}]
    run = _run(device_trace=TRACE, dispatches=log, submit_s=[0.1, 0.3])
    tri = spec.load_module("metrics", "trisolve_roofline.service")
    need = 4 * roofline.apply_bytes(9, 16, 2) + 2 * roofline.apply_bytes(9, 16, 4)
    assert tri.read(run) == pytest.approx(
        100 * need / HBM_BYTES_PER_S / 18e-6)
    spmv = spec.load_module("metrics", "spmv_roofline.service")
    need = 3 * roofline.spmv_bytes(9, 41, 2) + 1 * roofline.spmv_bytes(9, 41, 4)
    assert spmv.read(run) == pytest.approx(
        100 * need / HBM_BYTES_PER_S / 7e-6)
    fill = spec.load_module("metrics", "slab_fill.service")
    assert fill.read(run) == pytest.approx(100 * (2 / 8 + 4 / 8) / 2)
    sub = spec.load_module("metrics", "submit_ms.service")
    assert sub.read(run) == pytest.approx(200.0)


def test_readers_without_a_trace_return_nothing():
    run = _run(requests=[Request(0, 0.0, 1.0, 4, "CONVERGED")])
    for name in ("trisolve_roofline.solve", "spmv_roofline.solve",
                 "vector_ms_per_iter.solve", "idle_share.solve",
                 "trisolve_roofline.service", "spmv_roofline.service",
                 "idle_share.service"):
        assert spec.load_module("metrics", name).read(run) is None


def test_idle_gaps_name_the_host_range():
    t = DeviceTrace(window=(0.0, 100.0),
                    device=[(10.0, 20.0, "k1"), (60.0, 70.0, "k2")],
                    host_ranges=[(0.0, 50.0, "submit"),
                                 (50.0, 100.0, "step")],
                    host_ops=[(55.0, 58.0, "aten::copy_")])
    gaps = dict(map(tuple, t.idle_gaps()))
    # gap [20, 60] is cut at 50: 30 us in submit, 10 in step, of which the
    # piece [50, 60] starts outside the op [55, 58]
    assert gaps == pytest.approx({"submit": 10e-6 + 30e-6,
                                  "step": 10e-6 + 30e-6})
    t.host_ops.append((50.0, 52.0, "aten::copy_"))
    t.host_ops.sort()
    gaps = dict(map(tuple, t.idle_gaps()))
    assert gaps == pytest.approx({"submit": 40e-6, "step > aten::copy_":
                                  10e-6, "step": 30e-6})
    assert t.busy_s == pytest.approx(20e-6)
    assert t.by_name() == [["k1", pytest.approx(1e-5)],
                           ["k2", pytest.approx(1e-5)]]


def test_metric_modules_import_alone():
    importlib.import_module("portbench.lib.peaks")
