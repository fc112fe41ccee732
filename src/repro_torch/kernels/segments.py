"""Barrier-free segments of a round-major step table.

The trisolve kernels run the steps of a table in order, and on the card the
only barrier between two steps is the boundary between two launches.  One
launch per step is always safe.  Most of those barriers are not needed:
the paper's point is that HBMC needs one synchronisation per color, not one
per round (§4).  In the round-major tables a BMC block's rows sit in one
lane across its color's rounds, and the level-1 blocks of one color are
independent, so within a color a lane reads only what the same lane wrote,
plus what earlier colors wrote.

``barrier_segments`` finds the fewest launches that keep the result of the
step-major order, for this ownership contract of the kernels:

* one thread per (lane, column), the same lane at every step, runs the
  steps of one launch in order, and threads run in no order against each
  other;
* step ``g`` writes slice ``dest(g)`` of the state, each lane its own
  entry: ``dest(g) = g`` for a sweep table, and for a fused table
  ``dest(g) = g`` when ``g < S``, ``2S-1-g`` when ``g >= S``.  So position
  ``p`` is only ever written by lane ``p % R``, and a thread sees its own
  lane's writes in program order;
* a read at step ``g``, lane ``l``, of a position ``p`` with
  ``p % R != l`` ties ``g`` to every step that writes slice ``p // R``:
  the two must lie in different launches.  That covers both a read after
  another lane's write (RAW) and a write after another lane's read (WAR).

The gather positions are normalised as the kernels read them: ``c`` in
``[-m, 0)`` wraps to ``c + m``, and ``c`` outside ``[-m, m)`` (the hole
``S*R`` of the packing) reads nothing.  A step that reads another lane's
entry of the slice it writes itself can be cut by no barrier (not even one
launch per step); every packed table is free of it, and such a table
raises ``analysis.ScheduleError`` with the step as its witness.
``segment_ties`` states the rule once: ``barrier_segments`` cuts by it,
and ``analysis.schedule.check_segments`` proves any given cut against it.

Each tie needs a segment start in ``(min, max]`` of its two steps; the
fewest starts covering all ties are placed greedily at the right ends of
the ties in ascending order (interval stabbing).  The work is vectorised
over the table's entries and its (step, slice) pairs, with a loop over
steps only: 0.18-0.25 s for the (64, 32768, 4) table of a 1M-unknown
plan on one host core (``chip_smoke.py`` phase 3).

``single_paths`` picks the path of each launch of the single-RHS kernels
(B1, B5), and the wrappers pass its codes to them: the plain path, the
on-chip path or the lane-group path with ``lane_group(K, R)`` threads a
lane.  On the on-chip path a launch serves on chip every read of a value
it wrote itself: by the tie rule such a read is of the thread's own lane,
and its latest writer runs earlier in the thread's own loop.
``forwarded_reads`` marks those reads, for the tests and ``chip_smoke.py``.

``table_segments`` records the shape and the segment count of each table
it analyses (``analysed()``; cleared by ``kernels.reset_launch_counts``),
so that a reader can put a kernel's time over the steps it ran.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np

from ..spans import span


#: The single-RHS kernels' paths (``single_paths``).  On chip: a segment of
#: at least ON_CHIP_MIN_STEPS steps of a table of at most ON_CHIP_MAX_K
#: entries a row (``KP`` in ``csrc/hbmc_trisolve.cu``) whose entries count
#: below 2^31; a thread's ring keeps its last RING_STEPS outputs.  Lane
#: groups: a table of more than ON_CHIP_MAX_K entries a row runs G threads
#: of one warp a lane, G at most GROUP_MAX, with R x G at most GROUP_THREADS
#: (about half the H100's resident threads).
ON_CHIP_MIN_STEPS = 3
ON_CHIP_MAX_K = 8
RING_STEPS = 32
GROUP_MAX = 32
GROUP_THREADS = 132 * 1024

#: ``single_paths``' codes of the plain and the on-chip path; a code G > 1
#: is the lane-group path with G threads a lane
PLAIN, ON_CHIP = 0, 1


class Analysed(NamedTuple):
    """One table ``table_segments`` analysed: fused or a sweep, its steps
    (G), lanes (R) and entries a row (K), and its barrier-free segments,
    one launch each."""
    fused: bool
    steps: int
    lanes: int
    k: int
    segments: int


#: the last 4,096 tables analysed (a plan's tables are analysed once, at
#: their first apply)
_ANALYSED: collections.deque = collections.deque(maxlen=4096)


def analysed() -> list[Analysed]:
    """The tables ``table_segments`` analysed since the last
    ``kernels.reset_launch_counts()``, oldest first."""
    return list(_ANALYSED)


def reset_analysed() -> None:
    _ANALYSED.clear()


def step_dest(n_steps: int, fused: bool) -> np.ndarray:
    """Slice written by each step of a table of ``n_steps`` steps."""
    g = np.arange(n_steps)
    if not fused:
        return g
    s_ = n_steps // 2
    return np.where(g < s_, g, 2 * s_ - 1 - g)


def segment_ties(cols: np.ndarray, fused: bool
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Every tie of a step table: the pairs of steps that must lie in
    different launches, by the ownership contract of the module docstring.

    Args:
      cols: (G, R, K) gather positions of a round-major table (as for
        ``barrier_segments``).
      fused: whether ``cols`` is a fused table (G = 2S) or one sweep.

    Returns:
      (reader, writer): int64 arrays, one entry per tie: step ``reader``
      reads another lane's entry of a slice that step ``writer`` writes.
      Ordered by reader, then slice, first writers before second writers
      (a fused slice has two).  ``reader == writer`` marks a step that
      reads another lane's entry of the slice it writes itself, which no
      launch boundary can order.  This is the one statement of the rule:
      ``barrier_segments`` places its starts by it and
      ``analysis.schedule.check_segments`` checks a cut against it.
    """
    cols = np.asarray(cols)
    if cols.ndim != 3:
        raise ValueError(f"cols must be (G, R, K), got {cols.shape}")
    n_steps, r_, _ = cols.shape
    if fused and n_steps % 2:
        raise ValueError(f"a fused table has 2S steps, got {n_steps}")
    if n_steps == 0:
        none = np.zeros(0, dtype=np.int64)
        return none, none
    n_slices = n_steps // 2 if fused else n_steps
    m = n_slices * r_
    c = cols.astype(np.int64)
    c = np.where(c < 0, c + m, c)
    lane = np.arange(r_, dtype=np.int64)[None, :, None]
    other = (c >= 0) & (c < m) & (c % r_ != lane)
    step = np.broadcast_to(np.arange(n_steps, dtype=np.int64)[:, None, None],
                           c.shape)
    # (step, slice) pairs with a read of another lane's entry
    key = np.unique(step[other] * n_slices + c[other] // r_)
    g, slc = key // n_slices, key % n_slices
    # the steps that write each slice: g itself for a sweep, g and 2S-1-g
    # for the fused table
    writers = [slc] if not fused else [slc, 2 * n_slices - 1 - slc]
    return np.tile(g, len(writers)), np.concatenate(writers)


def barrier_segments(cols: np.ndarray, fused: bool) -> np.ndarray:
    """Start step of each barrier-free segment of a step table.

    Args:
      cols: (G, R, K) gather positions of a round-major table: the fused
        table of ``sell.fuse_round_major`` (``fused=True``, G = 2S) or one
        sweep of ``sell.to_round_major`` (``fused=False``, G = S).  The
        state has S*R positions.
      fused: which of the two tables ``cols`` is.

    Returns:
      int32 (n_segments,): ascending start steps, the first always 0.
      Segment i runs steps ``[starts[i], starts[i+1])``, the last one up to
      G.  Running each segment as one launch, with the ownership contract
      of the module docstring, gives the step-major result bit for bit.

    Raises:
      ``analysis.ScheduleError`` (a ``ValueError``) with an
      ``"intra-step-read"`` witness for a step that reads another lane's
      entry of the slice it writes.
    """
    cols = np.asarray(cols)
    reader, writer = segment_ties(cols, fused)
    if np.any(reader == writer):
        # deferred: the analysis package imports this module
        from ..analysis.schedule import ScheduleError, check_segments
        raise ScheduleError(check_segments(cols, [0], fused),
                            context="barrier_segments")
    if cols.shape[0] == 0:
        return np.zeros(1, dtype=np.int32)
    lo, hi = np.minimum(reader, writer), np.maximum(reader, writer)
    need = np.full(cols.shape[0], -1, dtype=np.int64)  # max lo of ties
    np.maximum.at(need, hi, lo)                        # ending at each step
    starts, last = [0], 0
    for h in np.flatnonzero(need >= 0):
        if last <= need[h]:           # no start in (need[h], h] yet
            starts.append(int(h))
            last = int(h)
    return np.asarray(starts, dtype=np.int32)


def table_segments(cols, fused: bool) -> np.ndarray:
    """``barrier_segments`` of a device table's ``cols`` (a tensor): the
    copy to the host and the analysis, timed as the ``segments`` span, and
    recorded in ``analysed()``."""
    with span("segments"):
        starts = barrier_segments(cols.cpu().numpy(), fused)
    steps, lanes, k = (int(x) for x in cols.shape)
    _ANALYSED.append(Analysed(bool(fused), steps, lanes, k, int(starts.size)))
    return starts


def lane_group(k: int, r: int) -> int:
    """Threads a lane that the single-RHS kernels give a table of ``k``
    entries a row and ``r`` lanes: 1 where ``k <= ON_CHIP_MAX_K``, else the
    largest power of two G <= ``GROUP_MAX`` with G <= k and r x G <=
    ``GROUP_THREADS``, or 1 where there is none."""
    if k <= ON_CHIP_MAX_K:
        return 1
    g = GROUP_MAX
    while g > 1 and (g > k or r * g > GROUP_THREADS):
        g //= 2
    return g


def single_paths(k: int, r: int, s: int, starts, fused: bool) -> np.ndarray:
    """The path of each launch of B1 / B5 on a table of ``k`` entries a
    row, ``r`` lanes and ``s`` slices (2S steps where ``fused``, else S),
    cut at the segment starts ``starts``.

    Returns:
      int32 (n_segments,): ``PLAIN`` (0), ``ON_CHIP`` (1), or G in {2, 4,
      8, 16, 32}, the lane-group path with G threads a lane.  Every launch
      takes the lane-group path where G = ``lane_group(k, r)`` > 1 and the
      state's S x R positions count below 2^31; otherwise a segment of at
      least ``ON_CHIP_MIN_STEPS`` steps of a table of 1 to
      ``ON_CHIP_MAX_K`` entries a row, whose entries count below 2^31,
      takes the on-chip path, and the rest the plain one.  The paths are
      bitwise each other; the wrappers pass these codes to the kernels and
      count their launches by them (``kernels.forwarding_counts``).
    """
    starts = np.asarray(starts, dtype=np.int64)
    n_steps = 2 * s if fused else s
    group = lane_group(k, r) if s * r < 2**31 else 1
    if group > 1:
        return np.full(starts.size, group, dtype=np.int32)
    fits = 1 <= k <= ON_CHIP_MAX_K and n_steps * r * k < 2**31
    lengths = np.diff(np.append(starts, n_steps))
    return ((lengths >= ON_CHIP_MIN_STEPS) & fits).astype(np.int32)


def forwarded_reads(cols: np.ndarray, segments, fused: bool) -> np.ndarray:
    """Which live gathers the single-RHS kernels serve on chip.

    Args:
      cols: (G, R, K) gather positions of a round-major table (as for
        ``barrier_segments``).
      segments: the ascending start steps the table is launched by.
      fused: whether ``cols`` is a fused table (G = 2S) or one sweep.

    Returns:
      bool (G, R, K): True where the gather of step g, lane l, entry k is
      live (``c`` wraps into ``[0, S*R)``, and for a forward step lies
      before slice g) and its launch serves it from registers or shared
      memory instead of y: the launch takes the on-chip path
      (``single_paths``), the position is lane l's own, and its latest
      writer before g
      -- step x for slice x, or the fused table's backward step 2S-1-x if
      that is before g -- lies in the segment, at most ``RING_STEPS``
      steps back.  A backward step's read of its own right-hand side is not
      a gather and is not counted.
    """
    cols = np.asarray(cols)
    n_steps, r_, k_ = cols.shape
    n_slices = n_steps // 2 if fused else n_steps
    starts = np.asarray(segments, dtype=np.int64)
    on_chip = single_paths(k_, r_, n_slices, starts, fused) == ON_CHIP
    if not on_chip.any():
        return np.zeros(cols.shape, dtype=bool)
    m = n_slices * r_
    seg = np.searchsorted(starts, np.arange(n_steps), side="right") - 1
    g0 = starts[seg][:, None, None]
    on_chip = on_chip[seg][:, None, None]
    g = np.arange(n_steps, dtype=np.int64)[:, None, None]
    c = cols.astype(np.int64)
    c = np.where(c < 0, c + m, c)
    lim = np.where((g < n_slices) | (not fused), g * r_, m)
    live = (c >= 0) & (c < lim)
    x, lane = np.divmod(np.where(live, c, 0), r_)
    own = live & (lane == np.arange(r_)[None, :, None])
    w = x
    if fused:
        back = 2 * n_slices - 1 - x
        w = np.where(back < g, back, x)
    return own & on_chip & (w >= g0) & (g - w <= RING_STEPS)
