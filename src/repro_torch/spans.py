"""Host-clock spans at the places where the port's solve and set-up work
happens, and the program's event counters.

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

The counters are one ``collections.Counter`` keyed ``"<layer>.<name>"``:
``count(key, n)`` adds, ``counts(prefix)`` reads the keys under a prefix,
``reset_counts(prefix)`` zeroes them, and ``snapshot()`` / ``add(delta,
times)`` let a CUDA graph take a capture's counts back out and add them once
per replay (``core/device_loop.py``).  The keys in use, and the views
that read them (each owner's reset zeroes its first part):

    kernels.calls.<wrapper>          kernels.launch_counts
    kernels.cuda.<wrapper>           kernels.cuda_launch_counts
    kernels.bytes.<wrapper>          kernels.operand_bytes
    kernels.path.<wrapper>.<path>    kernels.forwarding_counts
    mesh.gathers.<caller>            core.mesh.gather_counts
    loop.<event>                     core.device_loop.loop_counts
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


_counts: collections.Counter = collections.Counter()


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``key``."""
    _counts[key] += n


def counts(prefix: str) -> dict[str, int]:
    """The counters whose keys start with ``prefix``, keyed by the rest of
    their keys (a counter never counted is absent)."""
    cut = len(prefix)
    return {k[cut:]: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counts(prefix: str) -> None:
    """Zero the counters whose keys start with ``prefix``."""
    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]


def snapshot() -> dict[str, int]:
    """Every counter's value."""
    return dict(_counts)


def add(delta: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a difference of two ``snapshot()``s) to
    the counters."""
    for k, v in delta.items():
        _counts[k] += times * v
