"""The program's own spans (``repro_torch.spans``) over one run, on the
harness's clock.

The program's spans and the harness read the same clock,
``time.perf_counter()``: the run starts at ``run.t_process``, and its
window opens at ``run.t_process + run.setup_s`` and lasts ``run.window_s``.
Under ``--trace 1`` the profiler records the window as the
``portbench.window`` range, on its own clock (us).  ``to_trace`` maps a
host time onto the trace through the window's end alone, a microsecond for
a microsecond: the range opens 0.4-0.8 ms after the host's window on the
H100's host, and a map through both ends would spread that lag over the
window.  The clocks run at one rate: on the H100's host the profiler's
record of each solve's copy down (``aten::_to_copy``) starts 2-40 us after
its ``solve.extract`` span mapped so, and on thermal2 the upload's ends
50-70 us before its ``solve.embed`` span ends.  The spans never enter the
profiler: the trace's device records hold none of them.

A program without the recorder (a commit before it) has no spans: then
every function here returns None and the reader leaves its metric out.
"""
from __future__ import annotations

import bisect


def recorded() -> list | None:
    """The program's recent spans, ``(name, start, end, nbytes)`` records,
    or None where the program has no recorder."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.recent()


def window(run) -> tuple[float, float]:
    """The window's two ends on the host clock."""
    start = run.t_process + run.setup_s
    return start, start + run.window_s


def in_window(run, names: tuple[str, ...]) -> list | None:
    """Spans named in ``names`` that start inside the window."""
    got = recorded()
    if got is None:
        return None
    lo, hi = window(run)
    return [r for r in got if r.name in names and lo <= r.start < hi]


def in_setup(run, names: tuple[str, ...]) -> list | None:
    """Spans named in ``names`` of this run's set-up: started at or after
    the run's start and ended before its window opened."""
    got = recorded()
    if got is None:
        return None
    lo = window(run)[0]
    return [r for r in got
            if r.name in names and r.start >= run.t_process and r.end <= lo]


def seconds(records) -> float:
    return sum(r.end - r.start for r in records)


def to_trace(run, t: float) -> float:
    """Host time ``t`` (s) on the profiler's clock (us), through the
    window's end on both clocks."""
    return run.device_trace.window[1] - (window(run)[1] - t) * 1e6


def idle_us(run, records) -> list[float]:
    """For each span of ``records``, the device-idle microseconds of the
    trace inside it: its length on the trace less the union of device
    records it holds."""
    union = run.device_trace.union()
    ends = [e for _, e in union]
    out = []
    for r in records:
        a, b = to_trace(run, r.start), to_trace(run, r.end)
        busy = 0.0
        for s, e in union[bisect.bisect_right(ends, a):]:
            if s >= b:
                break
            busy += min(e, b) - max(s, a)
        out.append(max(b - a, 0.0) - busy)
    return out
