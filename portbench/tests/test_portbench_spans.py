"""The readers of the program's spans (``lib/spans.py`` and the six metrics
over it) on a hand-made ring and trace, whose profiler clock runs 5 ms
ahead of the host's; the same readers with no recorder in the program (a
commit before it); and a tiny traced run on the CPU through the harness."""
import sys

import pytest
from conftest import run_tiny, spec

from portbench.lib import spans
from portbench.lib.harness import Run
from portbench.lib.trace import DeviceTrace
from repro_torch.spans import Record

NEW = ("embed_ms.solve", "extract_ms.solve", "loop_idle_ms.solve",
       "host_copy_mib.solve", "segments_s", "capture_s")

#: the run starts at 100 s and its window is [110, 111) s on the host clock
RING = [
    Record("segments", 50.0, 51.0, 0),          # before the run: left out
    Record("segments", 104.0, 104.5, 0),
    Record("loop.first_block", 105.0, 105.25, 0),
    Record("loop.capture", 105.25, 105.75, 0),
    Record("solve.embed", 106.0, 106.5, 1 << 30),   # a warm solve: set-up
    Record("solve.embed", 110.1, 110.12, 3 << 20),
    Record("solve.loop", 110.12, 110.38, 0),
    Record("solve.extract", 110.38, 110.4, 3 << 20),
    Record("solve.embed", 110.5, 110.53, 3 << 20),
    Record("solve.loop", 110.53, 110.78, 0),
    Record("solve.extract", 110.78, 110.8, 5 << 20),
    Record("solve.embed", 111.0, 111.5, 1 << 30),   # after the window
]

#: the window on the profiler's clock is [5,000, 1,005,000) us; the first
#: loop maps to [125,000, 385,000) and idles 10 ms of it, the second to
#: [535,000, 785,000) and idles 20 ms
TRACE = DeviceTrace(
    window=(5_000.0, 1_005_000.0),
    device=[(100_000.0, 300_000.0, "void segment_single<double, true>()"),
            (310_000.0, 400_000.0, "void sell_spmv_kernel<double>()"),
            (500_000.0, 700_000.0, "void segment_single<double, true>()"),
            (720_000.0, 800_000.0, "void at::native::reduce_kernel()")],
    host_ranges=[], host_ops=[])


def _run() -> Run:
    import torch
    run = Run(workload="thermal2.solve", config={}, traffic={}, seed=0,
              seconds=1.0, traced=True, device=torch.device("cpu"),
              t_process=100.0)
    run.setup_s, run.window_s, run.device_trace = 10.0, 1.0, TRACE
    return run


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def test_the_clock_map_runs_from_the_window_end():
    run = _run()
    assert spans.window(run) == (110.0, 111.0)
    assert spans.to_trace(run, 110.0) == pytest.approx(5_000.0)
    assert spans.to_trace(run, 111.0) == pytest.approx(1_005_000.0)
    assert spans.to_trace(run, 110.12) == pytest.approx(125_000.0)
    # a profiler range that opens 0.5 ms late moves no mapped time
    run.device_trace = DeviceTrace(window=(5_500.0, 1_005_000.0),
                                   device=[], host_ranges=[], host_ops=[])
    assert spans.to_trace(run, 110.12) == pytest.approx(125_000.0)


def test_readers_on_a_hand_ring(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(RING))
    run = _run()
    assert _read("embed_ms.solve", run) == pytest.approx(25.0)
    assert _read("extract_ms.solve", run) == pytest.approx(20.0)
    assert _read("host_copy_mib.solve", run) == pytest.approx(7.0)
    assert _read("loop_idle_ms.solve", run) == pytest.approx(15.0)
    assert _read("segments_s", run) == pytest.approx(0.5)
    assert _read("capture_s", run) == pytest.approx(0.75)


def test_a_span_inside_one_device_record_idles_nothing(monkeypatch):
    run = _run()
    inside = Record("solve.loop", 110.15, 110.2, 0)    # [155,000, 205,000)
    gap = Record("solve.loop", 110.3, 110.35, 0)       # [305,000, 355,000)
    assert spans.idle_us(run, [inside, gap]) == pytest.approx([0.0, 5_000.0])


def test_readers_without_the_recorder(monkeypatch):
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    assert spans.recorded() is None
    run = _run()
    for name in NEW:
        assert _read(name, run) is None, name


def test_readers_with_nothing_to_read(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: [])
    run = _run()
    for name in NEW:
        assert _read(name, run) is None, name
    run.device_trace = None
    assert _read("loop_idle_ms.solve", run) is None


def test_tiny_traced_run_reports_the_host_path():
    line = run_tiny("thermal2.solve", seconds=2.0, traced=True)
    got = line["metrics"]
    for name in ("embed_ms.solve", "extract_ms.solve", "segments_s"):
        assert got[name]["value"] > 0, name
    # on the CPU nothing crosses to a device, there are no device records
    # and no graph is captured
    assert got["host_copy_mib.solve"]["value"] == 0
    assert "loop_idle_ms.solve" not in got and "capture_s" not in got
    assert not {d[0] for d in line["breakdown"]["device_ops"]} & {
        "solve.embed", "solve.loop", "solve.extract"}
