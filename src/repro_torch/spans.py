"""Host-clock spans at the places where the port's solve and set-up work
happens.

``with span(name) as rec:`` reads ``time.perf_counter()`` on entry and on
exit, and on exit appends ``Record(name, start, end, nbytes)`` to a ring of
the last ``RING`` spans.  ``rec.nbytes`` may be set inside the span, for
spans that move data between host and device; ``rec.seconds`` is the span's
length once it has ended.  A span is recorded whether its body returns or
raises.

The names in use, and what reads them:

    solve.embed, solve.loop, solve.extract   SolverPlan.solve, solve_batched,
        solve_slab (core/plan.py); portbench's ``*.solve`` readers
    loop.first_block, loop.capture           core/device_loop.py; capture_s
    segments                                 kernels/segments.py
        table_segments, at a table's first apply; segments_s
    build, build.ordering, build.factor,     SolverPlan's set-up and
        build.pack                           refactor; plan.timings
    kernels.load, kernels.compile            kernels/_build.py; chip_smoke

The clock is the host's, the same as a caller's ``time.perf_counter()``;
spans never enter ``torch.profiler`` (no ``record_function``, no NVTX), so a
profiled run's device records hold none of them.
"""
from __future__ import annotations

import collections
from time import perf_counter
from typing import NamedTuple

#: spans the ring keeps (a 51-s thermal2 window makes some 200)
RING = 65_536


class Record(NamedTuple):
    name: str
    start: float      # s, time.perf_counter()
    end: float
    nbytes: int       # bytes the span moved between host and device

    @property
    def seconds(self) -> float:
        return self.end - self.start


_ring: collections.deque = collections.deque(maxlen=RING)


class span:
    """A span named ``name``: a context manager that yields its own record
    (``nbytes`` may be set inside it, ``seconds`` read after it).  A class
    and not a function, and plain tuples in the ring, to keep a span near
    1 us on the host."""
    __slots__ = ("name", "start", "end", "nbytes")

    def __init__(self, name: str):
        self.name = name
        self.nbytes = 0

    def __enter__(self) -> "span":
        self.start = perf_counter()
        return self

    def __exit__(self, kind, value, tb) -> None:
        self.end = perf_counter()
        _ring.append((self.name, self.start, self.end, self.nbytes))

    @property
    def seconds(self) -> float:
        return self.end - self.start


def recent(name: str | None = None) -> list[Record]:
    """The last ``RING`` spans (those named ``name``, if given), in the
    order they ended."""
    return [Record._make(r) for r in _ring if name is None or r[0] == name]


def reset() -> None:
    _ring.clear()
