"""The traced window: ``torch.profiler`` over the window, reduced to device
intervals, busy time, time by device operation and idle gaps labelled by
what the host was doing.

The harness marks its own calls with ``record_function`` ranges named
``portbench.<what>`` (``portbench.window`` spans the traced window;
``portbench.solve``, ``portbench.submit``, ``portbench.step``,
``portbench.rhs`` the calls into the program and the harness's own work).
A device operation is every record the profiler puts on the device:
kernels, memory copies and sets.
"""
from __future__ import annotations

import bisect
import dataclasses

WINDOW_RANGE = "portbench.window"
_PREFIX = "portbench."


@dataclasses.dataclass
class DeviceTrace:
    window: tuple[float, float]          # us, the profiler's clock
    device: list[tuple[float, float, str]]   # (start us, end us, name)
    host_ranges: list[tuple[float, float, str]]  # the harness's ranges
    host_ops: list[tuple[float, float, str]]     # every other host op

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def union(self) -> list[tuple[float, float]]:
        """Merged device intervals, clipped to the window."""
        lo, hi = self.window
        out: list[list[float]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e6

    def seconds_where(self, keep) -> float:
        """Summed device seconds of the records whose name ``keep``
        accepts (overlaps counted once per record)."""
        return sum(e - s for s, e, name in self.device if keep(name)) / 1e6

    def by_name(self, top: int = 10) -> list[list]:
        sums: dict[str, float] = {}
        for s, e, name in self.device:
            sums[name] = sums.get(name, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in
                sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device seconds inside the window, summed by what the host
        was doing: each gap is cut where the harness's ranges begin and
        end, and each piece is named by its range and by the innermost
        host op under it at the piece's start."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.union():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        cuts = sorted({x for s, e, _ in self.host_ranges for x in (s, e)})
        sums: dict[str, float] = {}
        for s, e in gaps:
            i = bisect.bisect_right(cuts, s)
            edges = [s, *cuts[i:bisect.bisect_left(cuts, e)], e]
            for a, b in zip(edges, edges[1:]):
                label = _innermost(self.host_ranges, a) or "harness"
                op = _innermost(self.host_ops, a)
                if op:
                    label = f"{label} > {op}"
                sums[label] = sums.get(label, 0.0) + (b - a) / 1e6
        return [[n, v] for n, v in
                sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def idle_share(t: DeviceTrace | None):
    """Percent of the traced window in which no operation ran on the
    device: one less the union of its records over the window's length.
    None without a trace or without device records."""
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _innermost(spans: list[tuple[float, float, str]], t: float) -> str:
    """Name of the latest-starting span holding ``t`` among the 64 that
    start last before it (``spans`` sorted by start): for nested spans the
    innermost.  '' when none does."""
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    for s, e, n in reversed(spans[max(0, i - 64):i]):
        if s <= t < e:
            return n
    return ""


def reduce(prof) -> DeviceTrace:
    """A finished ``torch.profiler.profile`` -> ``DeviceTrace``."""
    from torch.autograd import DeviceType
    device, ranges, ops, window = [], [], [], None
    for ev in prof.events():
        span = (float(ev.time_range.start), float(ev.time_range.end),
                ev.name)
        if ev.device_type == DeviceType.CUDA:
            # the profiler may mirror a host range onto the device's
            # timeline; only the device's own records count
            if not ev.name.startswith(_PREFIX):
                device.append(span)
        elif ev.name == WINDOW_RANGE:
            window = span[:2]
        elif ev.name.startswith(_PREFIX):
            ranges.append((span[0], span[1], ev.name[len(_PREFIX):]))
        else:
            ops.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    return DeviceTrace(window=window, device=device,
                       host_ranges=sorted(ranges), host_ops=sorted(ops))
