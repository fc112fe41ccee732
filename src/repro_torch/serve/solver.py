"""Solver-as-a-service: continuous batching of RHS streams over warm plans.

Port of ``repro.serve.solver`` onto the port's ``SolverPlan``: the slab
steps run the batched CUDA kernels on the card (their plain versions on
the CPU).  Host reads per dispatch are one ``.cpu()`` each of the slab's
``active``/``iters``/``relres``/``status`` and, per retiring request, of
its own column of ``x`` -- never the whole (m, B) slab.

The HBMC pipeline's expensive products — ordering, rounds, IC(0) factor,
packed tables — are all cached inside a ``SolverPlan``; this module
amortizes them across *clients*:

``PlanCache``
    LRU cache of built plans keyed by sparsity-pattern fingerprint (a hash
    of the CSR ``indptr``/``indices``) plus every build knob that changes
    the solver (method, dtype, device, ...).  A request whose
    pattern is cached but whose values changed takes the
    ``plan.refactor`` fast path — numeric factorization only — instead of
    a full rebuild.  Plans with in-flight slabs are
    *pinned* and never evicted.

``SolverService``
    A request queue that packs heterogeneous right-hand sides into
    resident PCG slabs of a configurable width (``plan.run_slab``) and
    advances each slab a bounded ``quantum`` of iterations per dispatch.
    Converged columns retire between dispatches — they report their
    iteration count, free their slot, and a fresh queued request is packed
    in on the next dispatch — so a slab never runs every column to the
    slowest straggler.

Numerical contract (pinned by tests/test_torch_serve.py): a request
served at slab width B in slot s is bitwise equal to the standalone
``plan.solve_slab(b, slab_width=B, slot=s)`` on a fresh plan —
independent of which requests shared its slab, of dispatch quantum, and
of retire/refill interleaving.  (Width and slot may pin the reduction
order; at B = 1 the oracle coincides with
``plan.solve_batched(b[:, None])``.)  Iteration counts equal the
single-RHS ``plan.solve`` counts at every width and slot.

Scheduling is single-threaded and deterministic: ``step()`` advances the
whole service one admit → pack → dispatch → retire cycle, and a
``VirtualClock`` with an event cost model replaces wall time in tests (no
sleeps, no threads).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import scipy.sparse as sp
import torch

from ..analysis.schedule import assert_plan_valid, check_validate_mode
from ..core.iccg import (DIVERGENCE_FACTOR, STAGNATION_WINDOW,
                         UNHEALTHY_STATUSES, SlabState, status_name)
from ..core.ic0 import FactorBreakdownError
from ..core.plan import _NP_DTYPES, SPMV_FORMATS, SolverPlan, build_plan
from ..core.trisolve import LAYOUTS
from ..kernels.config import DEFAULT_DEVICE, resolve_device

# ---------------------------------------------------------------------------
# Fingerprints and cache keys
# ---------------------------------------------------------------------------


def _as_csr(a: sp.spmatrix) -> sp.csr_matrix:
    a = sp.csr_matrix(a)
    a.sum_duplicates()   # duplicate-entry CSR corrupts packing downstream
    a.sort_indices()
    return a


def pattern_fingerprint(a: sp.spmatrix) -> str:
    """Hash of the sparsity pattern only (shape + CSR indptr/indices)."""
    a = _as_csr(a)
    h = hashlib.sha1()
    h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(a.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(a.indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def values_fingerprint(a: sp.spmatrix) -> str:
    """Hash of the numeric values (CSR data, canonical index order)."""
    a = _as_csr(a)
    return hashlib.sha1(np.ascontiguousarray(a.data).tobytes()).hexdigest()


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Everything that decides whether two requests can share one plan.

    Pattern fingerprint + the build knobs of the port's ``build_plan``.
    Two matrices with equal keys but different values share the plan
    through ``refactor``; anything else is a distinct cache entry.
    ``dtype`` is the numpy name of the torch dtype, ``device`` the
    resolved device (``"cuda:0"``, ``"cpu"``).
    """
    pattern: str
    n: int
    method: str
    block_size: int
    w: int
    shift: float
    spmv_format: str
    dtype: str
    layout: str
    device: str
    lane_multiple: int = 1
    on_breakdown: str = "clamp"
    scheduler: str = "coloring"

    @classmethod
    def from_matrix(cls, a: sp.spmatrix, *, method: str = "hbmc",
                    block_size: int = 32, w: int = 8, shift: float = 0.0,
                    spmv_format: str = "sell",
                    dtype: torch.dtype = torch.float64,
                    layout: str = "round_major", lane_multiple: int = 1,
                    on_breakdown: str = "clamp",
                    scheduler: str = "coloring",
                    device: str | torch.device = DEFAULT_DEVICE,
                    **extra) -> tuple["PlanKey", sp.csr_matrix]:
        """Key for (a, knobs); also returns the canonicalized CSR matrix.

        ``layout`` is ``"round_major"`` or ``"index"``, ``spmv_format``
        ``"sell"`` or ``"ell"``; an unknown value raises ``ValueError``
        before the matrix is hashed.  The JAX-only knobs (``backend``,
        ``spmv_backend``, ``interpret``) are unknown knobs here
        (``TypeError``).  A mesh plan is refused (``ValueError``), as in
        the reference; ``lane_multiple`` is part of the key.
        """
        if extra.get("mesh") is not None:
            raise ValueError("mesh plans are not cacheable: a mesh binds "
                             "the plan to a device set; serve single-device "
                             "plans (or shard outside the service)")
        extra.pop("mesh", None)
        if extra:
            raise TypeError(f"unknown plan knobs: {sorted(extra)}")
        if dtype not in _NP_DTYPES:
            raise TypeError(f"dtype must be torch.float64 or torch.float32, "
                            f"got {dtype}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; expected one of "
                             f"{LAYOUTS}")
        if spmv_format not in SPMV_FORMATS:
            raise ValueError(f"unknown spmv_format {spmv_format!r}; "
                             f"expected one of {SPMV_FORMATS}")
        a = _as_csr(a)
        key = cls(pattern=pattern_fingerprint(a), n=int(a.shape[0]),
                  method=method, block_size=int(block_size), w=int(w),
                  shift=float(shift), spmv_format=spmv_format,
                  dtype=str(np.dtype(_NP_DTYPES[dtype])), layout=layout,
                  device=str(resolve_device(device)),
                  lane_multiple=int(lane_multiple),
                  on_breakdown=on_breakdown, scheduler=scheduler)
        return key, a


class PlanBusyError(RuntimeError):
    """Raised when a value-change refactor targets a pinned (in-flight)
    plan: refactoring would corrupt resident slab columns mid-solve."""


class QueueFullError(RuntimeError):
    """Backpressure: ``submit`` refused because the service's bounded
    queue (``max_queue``) is at capacity.  The caller should retry later
    or shed load — nothing was enqueued."""


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    refactors: int = 0
    evictions: int = 0
    pinned_overflow: int = 0   # capacity exceeded but every entry pinned
    admission_seconds: float = 0.0   # spent validating misses (validate=)

    @property
    def requests(self) -> int:
        return self.hits + self.misses + self.refactors

    @property
    def hit_rate(self) -> float:
        n = self.requests
        # a refactor reuses the expensive setup products: count it warm
        return (self.hits + self.refactors) / n if n else 0.0


@dataclasses.dataclass
class _CacheEntry:
    plan: SolverPlan
    values_fp: str
    pins: int = 0


class PlanCache:
    """LRU cache of built ``SolverPlan``s with pin-aware eviction.

    ``get`` returns ``(plan, status)`` with status one of:

    * ``"hit"``       — pattern and values both cached
    * ``"refactor"``  — pattern cached, values renewed via the numeric
      fast path (raises ``PlanBusyError`` if the entry is pinned)
    * ``"miss"``      — full build (evicting LRU *unpinned* entries if
      over capacity; a ``pin=True`` newcomer is protected by its own pin,
      so when every resident is pinned the cache overflows temporarily
      and records ``pinned_overflow``, while an unpinned newcomer is
      simply not retained)

    ``pin``/``unpin`` bracket in-flight use (the ``SolverService`` pins a
    key while a slab group holds resident columns, via ``get(pin=True)``);
    pinned entries are never evicted and never refactored out from under
    their slabs.

    ``validate`` gates cache admission: on a miss the freshly built plan
    is run through the static schedule race detector
    (``repro_torch.analysis.assert_plan_valid``) at that depth before it
    is cached or returned -- a plan with a provable schedule race (a
    segment cut that would race on the card included) raises
    ``ScheduleError`` and never enters the cache, so no later hit can
    dispatch it.  ``"deep"`` extends admission to the kernel checks and
    the dtype-flow lint of every path.  ``"off"`` (default) admits
    unconditionally.
    """

    def __init__(self, capacity: int = 8,
                 build: Callable[..., SolverPlan] = build_plan,
                 validate: str = "off"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        check_validate_mode(validate)
        self.capacity = capacity
        self._build = build
        self.validate = validate
        self._entries: OrderedDict[PlanKey, _CacheEntry] = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries)

    def pins(self, key: PlanKey) -> int:
        return self._entries[key].pins if key in self._entries else 0

    def get(self, a: sp.spmatrix, pin: bool = False,
            **knobs) -> tuple[SolverPlan, str]:
        """Plan for (a, knobs): cached, refactored, or freshly built.

        ``pin=True`` pins the entry atomically with the lookup/insert —
        the caller must balance it with ``unpin`` when its slab drains.
        """
        key, a = PlanKey.from_matrix(a, **knobs)
        vfp = values_fingerprint(a)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            if entry.values_fp == vfp:
                entry.pins += pin
                self.stats.hits += 1
                return entry.plan, "hit"
            if entry.pins:
                raise PlanBusyError(
                    f"plan {key.pattern[:12]} has {entry.pins} in-flight "
                    f"slab(s); refactoring now would corrupt resident "
                    f"columns — drain the slab first")
            entry.plan.refactor(a)
            entry.values_fp = vfp
            entry.pins += pin
            self.stats.refactors += 1
            return entry.plan, "refactor"
        knobs.pop("mesh", None)             # validated None by the key
        plan = self._build(a, **knobs)
        if self.validate != "off":
            # admission control: prove the schedule race-free before the
            # plan can be cached (and re-served on every later hit)
            t0 = time.perf_counter()
            try:
                assert_plan_valid(plan, self.validate,
                                  context=f"PlanCache admission "
                                          f"{key.pattern[:12]}")
            finally:
                self.stats.admission_seconds += time.perf_counter() - t0
        self._entries[key] = _CacheEntry(plan=plan, values_fp=vfp,
                                         pins=int(pin))
        self.stats.misses += 1
        self._evict()
        return plan, "miss"

    def _evict(self) -> None:
        while len(self._entries) > self.capacity:
            victim = next((k for k, e in self._entries.items()
                           if e.pins == 0), None)
            if victim is None:
                self.stats.pinned_overflow += 1
                return
            del self._entries[victim]
            self.stats.evictions += 1

    def pin(self, key: PlanKey) -> None:
        self._entries[key].pins += 1

    def unpin(self, key: PlanKey) -> None:
        entry = self._entries[key]
        if entry.pins <= 0:
            raise RuntimeError(f"unpin without pin for {key.pattern[:12]}")
        entry.pins -= 1
        self._evict()   # a deferred eviction may now be possible


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


class WallClock:
    """Real time; event charges are no-ops (the events take real time)."""

    simulated = False

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def charge(self, event: str, n: int = 1) -> None:
        pass


#: Default virtual event costs (arbitrary deterministic units): a build is
#: an order of magnitude above a refactor, which dwarfs per-dispatch work.
DEFAULT_COSTS = {
    "build": 1.0,
    "refactor": 0.1,
    "hit": 0.0,
    "dispatch": 0.05,
    "iteration": 0.01,
    "pack": 0.001,
    "retire": 0.001,
}


class VirtualClock:
    """Deterministic simulated time driven by an event cost model.

    Tests drive the service with seeded arrival traces against this clock:
    no wall-clock sleeps, no threads, and every latency/throughput number
    reproduces bit-for-bit across runs.
    """

    simulated = True

    def __init__(self, costs: dict[str, float] | None = None):
        self.t = 0.0
        self.costs = dict(DEFAULT_COSTS)
        if costs:
            self.costs.update(costs)

    def now(self) -> float:
        return self.t

    def charge(self, event: str, n: int = 1) -> None:
        self.t += n * self.costs.get(event, 0.0)

    def advance_to(self, t: float) -> None:
        if t > self.t:
            self.t = t


# ---------------------------------------------------------------------------
# Requests, slab groups, and the service
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Request:
    rid: int
    key: PlanKey
    values_fp: str
    a: sp.csr_matrix          # kept until packed (plan build / refactor)
    b: np.ndarray
    tag: Any
    arrival: float
    deadline: float = np.inf  # absolute service-clock time; inf = none
    started: float = -1.0
    plan_status: str = ""     # cache status when its slab group resolved


#: Terminal request statuses added by the serving layer on top of the
#: core taxonomy (``repro_torch.core.STATUS_NAMES``).
SERVICE_STATUSES = ("CANCELLED", "DEADLINE")


@dataclasses.dataclass
class Completed:
    """A retired request: solution + solve metadata + timing.

    ``status`` is always definite: one of the core taxonomy
    (``CONVERGED | MAXITER | BREAKDOWN | DIVERGED | STAGNATED``) or a
    serving-layer terminal (``CANCELLED | DEADLINE``).  ``x`` is None for
    requests that never produced a usable iterate (cancellation before
    packing, factorization breakdown, unhealthy solves); a DEADLINE expiry
    of an in-flight column returns its best-effort partial iterate.
    """
    rid: int
    tag: Any
    x: np.ndarray | None      # solution in the caller's original ordering
    iterations: int
    relres: float
    converged: bool
    arrival: float
    started: float            # -1.0 if never packed into a slab
    finished: float
    plan_status: str          # "hit" | "refactor" | "miss" | "" (never packed)
    slab_width: int           # 0 if never packed
    slot: int                 # slab column that served this request; -1 if none
    status: str = "CONVERGED"

    @property
    def latency(self) -> float:
        return self.finished - self.arrival

    @property
    def queue_wait(self) -> float:
        return (self.started if self.started >= 0 else self.finished) \
            - self.arrival

    @property
    def failed(self) -> bool:
        return self.status not in ("CONVERGED", "MAXITER")


class _SlabGroup:
    """One resident slab: a plan, its device state, and slot bookkeeping.

    All columns of a group share one (plan, values) pair by construction —
    a slab can never mix incompatible plans or matrices.  ``pack`` and
    ``clear`` write the slot in place: the group alone holds its state
    (``new_slab_state`` made it, and ``run_slab`` hands back a new one
    whose tensors only the discarded old state may share).
    """

    def __init__(self, key: PlanKey, plan: SolverPlan, values_fp: str,
                 width: int):
        self.key = key
        self.plan = plan
        self.values_fp = values_fp
        self.width = width
        self.state: SlabState = plan.new_slab_state(width)
        self.slots: list[_Request | None] = [None] * width

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_occupied(self) -> int:
        return sum(s is not None for s in self.slots)

    def pack(self, slot: int, req: _Request) -> None:
        if req.key != self.key or req.values_fp != self.values_fp:
            raise AssertionError("attempted to pack a request into a slab "
                                 "of a different plan/matrix")
        if self.slots[slot] is not None:
            raise AssertionError(f"slot {slot} is occupied")
        self.state.r[:, slot] = self.plan.embed_rhs(req.b)
        self.state.fresh[slot] = True
        self.slots[slot] = req

    def clear(self, slot: int) -> None:
        # a zero fresh column re-initializes inert (relres 0 < rtol)
        self.state.r[:, slot] = 0.0
        self.state.fresh[slot] = True
        self.slots[slot] = None


class SolverService:
    """Continuous-batching front end over a ``PlanCache``.

    ``submit(a, b)`` enqueues one right-hand side against matrix ``a``;
    ``step()`` advances the service one scheduling cycle; ``drain()``
    steps until everything admitted has completed.  See the module
    docstring for the lifecycle and the numerical contract.

    Scheduling is FIFO *per plan key*: a request that cannot be placed
    (its group is full, or its matrix values differ from the group's)
    blocks later requests of the same key — never requests of other keys.
    A value-change request therefore waits for the group to drain, then
    takes the ``refactor`` fast path.

    Robustness: every request terminates with a definite ``status``.
    Columns whose slab health goes terminal-unhealthy (BREAKDOWN /
    DIVERGED / STAGNATED) retire the moment their dispatch ends —
    quarantined (``n_quarantined``), slot freed — instead of holding the
    slab for their full ``maxiter`` budget; their slab neighbours are
    untouched (bitwise — column ops never mix lanes).  A matrix whose
    factorization raises :class:`FactorBreakdownError` fails its request
    with status BREAKDOWN and poisons its (key, values) pair so follow-up
    requests fail fast without re-attempting the build.  ``max_queue``
    bounds admission (``QueueFullError``), ``timeout=``/``default_timeout``
    set per-request deadlines on the service clock, and ``cancel`` revokes
    queued or in-flight requests immediately.  ``validate`` is the
    admission depth of the ``PlanCache`` the service makes (a given
    ``cache`` keeps its own; a different mode there raises).
    """

    def __init__(self, cache: PlanCache | None = None, *,
                 slab_width: int = 8, quantum: int = 16,
                 rtol: float = 1e-7, maxiter: int = 10_000,
                 clock=None, record_dispatches: bool = False,
                 max_queue: int | None = None,
                 default_timeout: float | None = None,
                 divergence_factor: float | None = DIVERGENCE_FACTOR,
                 stagnation_window: int | None = STAGNATION_WINDOW,
                 validate: str = "off", **plan_knobs):
        if slab_width < 1:
            raise ValueError(f"slab_width must be >= 1, got {slab_width}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if cache is None:
            cache = PlanCache(validate=validate)
        elif validate not in ("off", cache.validate):
            raise ValueError(f"validate={validate!r} disagrees with the "
                             f"given cache's {cache.validate!r}; build the "
                             f"PlanCache with it")
        self.cache = cache
        self.slab_width = slab_width
        self.quantum = quantum
        self.rtol = rtol
        self.maxiter = maxiter
        self.max_queue = max_queue
        self.default_timeout = default_timeout
        self.divergence_factor = divergence_factor
        self.stagnation_window = stagnation_window
        self.clock = clock if clock is not None else WallClock()
        self.plan_knobs = dict(plan_knobs)
        self._np_dtype = np.dtype(_NP_DTYPES.get(
            self.plan_knobs.get("dtype", torch.float64), np.float64))
        self._next_rid = 0
        self._queue: list[_Request] = []          # admitted, FIFO
        self._pending: list[_Request] = []        # future arrivals (virtual)
        self._groups: "OrderedDict[PlanKey, _SlabGroup]" = OrderedDict()
        self.completed: dict[int, Completed] = {}
        self.record_dispatches = record_dispatches
        self.dispatch_log: list[dict] = []
        self.n_quarantined = 0
        # (key, values_fp) pairs whose factorization broke down terminally
        self._poisoned: set[tuple[PlanKey, str]] = set()

    # -- submission ---------------------------------------------------------

    def submit(self, a: sp.spmatrix, b: np.ndarray, *,
               arrival_time: float | None = None, tag: Any = None,
               timeout: float | None = None) -> int:
        """Enqueue one RHS; returns a request id.

        ``arrival_time`` (simulated clocks only) defers admission until
        the virtual clock reaches it — the hook for seeded arrival traces.
        ``timeout`` (service-clock seconds from arrival; defaults to the
        service's ``default_timeout``) sets the request's deadline: a
        request not finished by then terminates with status DEADLINE.
        Raises :class:`QueueFullError` when ``max_queue`` requests are
        already waiting (backpressure — nothing is enqueued).
        """
        if (self.max_queue is not None
                and len(self._queue) + len(self._pending) >= self.max_queue):
            raise QueueFullError(
                f"queue is at capacity ({self.max_queue} waiting); retry "
                f"later or shed load")
        b = np.asarray(b)
        if b.ndim != 1:
            raise ValueError(
                f"SolverService.submit takes one RHS of shape (n,), got "
                f"{b.shape}; the service packs requests into slabs itself "
                f"— submit columns individually")
        if b.shape[0] != a.shape[0]:
            raise ValueError(f"b has shape {b.shape} but a is "
                             f"{a.shape[0]}x{a.shape[1]}")
        if (np.issubdtype(b.dtype, np.floating)
                and b.dtype != self._np_dtype):
            raise TypeError(
                f"submit: b has dtype {b.dtype} but the service's plans "
                f"are {self._np_dtype}; cast b explicitly to opt in")
        key, a_csr = PlanKey.from_matrix(a, **self.plan_knobs)
        if arrival_time is None:
            arrival = self.clock.now()
        else:
            if not getattr(self.clock, "simulated", False):
                raise ValueError(
                    "arrival_time= requires a simulated clock "
                    "(VirtualClock); with a wall clock, pace submissions "
                    "from the caller instead")
            arrival = float(arrival_time)
        if timeout is None:
            timeout = self.default_timeout
        if timeout is not None and timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        deadline = np.inf if timeout is None else arrival + float(timeout)
        req = _Request(rid=self._next_rid, key=key,
                       values_fp=values_fingerprint(a_csr), a=a_csr,
                       b=np.asarray(b, dtype=self._np_dtype), tag=tag,
                       arrival=arrival, deadline=deadline)
        self._next_rid += 1
        if arrival_time is None:
            self._queue.append(req)
        else:
            self._pending.append(req)
            self._pending.sort(key=lambda r: (r.arrival, r.rid))
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Revoke a request immediately; returns True if it was revoked.

        Works on pending, queued and in-flight requests: the request
        completes with status CANCELLED (``x = None``), an in-flight
        column's slot is freed at once.  Returns False when ``rid`` is
        unknown or already completed (too late to cancel).
        """
        for lst in (self._queue, self._pending):
            for i, req in enumerate(lst):
                if req.rid == rid:
                    del lst[i]
                    self._fail(req, "CANCELLED")
                    return True
        for key, group in self._groups.items():
            for slot, req in enumerate(group.slots):
                if req is not None and req.rid == rid:
                    group.clear(slot)
                    self._fail(req, "CANCELLED", slab_width=group.width,
                               slot=slot)
                    return True
        return False

    def _fail(self, req: _Request, status: str, *,
              x: np.ndarray | None = None, iterations: int = 0,
              relres: float = np.inf, slab_width: int = 0,
              slot: int = -1) -> Completed:
        """Terminate ``req`` with a non-success ``status`` right now."""
        c = Completed(rid=req.rid, tag=req.tag, x=x, iterations=iterations,
                      relres=relres, converged=False, arrival=req.arrival,
                      started=req.started, finished=self.clock.now(),
                      plan_status=req.plan_status, slab_width=slab_width,
                      slot=slot, status=status)
        self.completed[req.rid] = c
        return c

    def _reap_expired(self) -> list[Completed]:
        """Fail every waiting request whose deadline has passed."""
        now = self.clock.now()
        done: list[Completed] = []
        for lst in (self._queue, self._pending):
            expired = [r for r in lst if r.deadline <= now]
            if expired:
                lst[:] = [r for r in lst if r.deadline > now]
                done.extend(self._fail(r, "DEADLINE") for r in expired)
        return done

    # -- scheduling ---------------------------------------------------------

    @property
    def n_in_flight(self) -> int:
        return sum(g.n_occupied for g in self._groups.values())

    @property
    def n_queued(self) -> int:
        return len(self._queue) + len(self._pending)

    def _admit_due(self) -> None:
        now = self.clock.now()
        while self._pending and self._pending[0].arrival <= now:
            self._queue.append(self._pending.pop(0))

    def _resolve_group(self, req: _Request) -> _SlabGroup | None:
        """Group able to take ``req`` now, creating one if possible.

        Returns None when the key is blocked this cycle: the live group is
        full, or holds different matrix values (refactor must wait for it
        to drain — tearing it down mid-flight would corrupt columns).
        """
        group = self._groups.get(req.key)
        if group is not None:
            if group.values_fp != req.values_fp:
                return None
            return group if group.free_slots() else None
        plan, status = self.cache.get(req.a, pin=True, **self.plan_knobs)
        self.clock.charge(status)   # build / refactor / hit cost
        group = _SlabGroup(req.key, plan, req.values_fp, self.slab_width)
        group.creation_status = status
        self._groups[req.key] = group
        return group

    def _pack_queue(self) -> None:
        """FIFO pass over the queue; per-key blocking preserves order
        within a key while other keys keep flowing.

        A request whose plan build/refactor raises
        :class:`FactorBreakdownError` (the ``on_breakdown`` policy refused
        a degraded factor, or the matrix itself is non-finite) fails with
        status BREAKDOWN and poisons its (key, values) pair — identical
        follow-ups fail fast without re-running the factorization.
        """
        blocked: set[PlanKey] = set()
        remaining: list[_Request] = []
        for req in self._queue:
            if req.key in blocked:
                remaining.append(req)
                continue
            if (req.key, req.values_fp) in self._poisoned:
                self._fail(req, "BREAKDOWN")
                continue
            try:
                group = self._resolve_group(req)
            except FactorBreakdownError:
                self.clock.charge("build")   # the attempt was paid for
                self._poisoned.add((req.key, req.values_fp))
                self._fail(req, "BREAKDOWN")
                continue
            if group is None:
                blocked.add(req.key)
                remaining.append(req)
                continue
            slot = group.free_slots()[0]
            req.started = self.clock.now()
            req.plan_status = getattr(group, "creation_status", "hit")
            # the group creator reports the cache status; later riders of
            # the live group are warm by definition
            group.creation_status = "hit"
            group.pack(slot, req)
            req.a = None    # matrix no longer needed; free the reference
            self.clock.charge("pack")
            if not group.free_slots():
                blocked.add(req.key)
        self._queue = remaining

    def _dispatch_and_retire(self) -> list[Completed]:
        done: list[Completed] = []
        for key in list(self._groups):
            group = self._groups[key]
            if group.n_occupied == 0:
                self._teardown(key)
                continue
            group.state, steps = group.plan.run_slab(
                group.state, rtol=self.rtol, maxiter=self.maxiter,
                quantum=self.quantum,
                divergence_factor=self.divergence_factor,
                stagnation_window=self.stagnation_window)
            steps = int(steps)
            self.clock.charge("dispatch")
            self.clock.charge("iteration", steps)
            if self.record_dispatches:
                self.dispatch_log.append({
                    "key": key, "values_fp": group.values_fp,
                    "rids": [s.rid if s is not None else None
                             for s in group.slots],
                    "steps": steps,
                })
            active = group.state.active.cpu().numpy()
            iters = group.state.iters.cpu().numpy()
            relres = group.state.relres.cpu().numpy()
            codes = group.state.status.cpu().numpy()
            now = self.clock.now()
            for slot, req in enumerate(group.slots):
                if req is None:
                    continue
                if active[slot]:
                    if req.deadline > now:
                        continue
                    # in-flight deadline expiry: terminate with the
                    # best-effort partial iterate, free the slot now
                    self.clock.charge("retire")
                    done.append(self._fail(
                        req, "DEADLINE",
                        x=group.plan.extract_solution(group.state.x[:, slot]),
                        iterations=int(iters[slot]),
                        relres=float(relres[slot]),
                        slab_width=group.width, slot=slot))
                    group.clear(slot)
                    continue
                st = status_name(codes[slot])
                unhealthy = st in UNHEALTHY_STATUSES
                if unhealthy:
                    # quarantine: structured failure, slot freed this very
                    # dispatch — no iterate is returned (the column's last
                    # finite state is not a solution)
                    self.n_quarantined += 1
                    self.clock.charge("retire")
                    done.append(self._fail(
                        req, st, iterations=int(iters[slot]),
                        relres=float(relres[slot]),
                        slab_width=group.width, slot=slot))
                    group.clear(slot)
                    continue
                self.clock.charge("retire")
                rr = float(relres[slot])
                done.append(Completed(
                    rid=req.rid, tag=req.tag,
                    x=group.plan.extract_solution(group.state.x[:, slot]),
                    iterations=int(iters[slot]), relres=rr,
                    converged=rr < self.rtol, arrival=req.arrival,
                    started=req.started, finished=self.clock.now(),
                    plan_status=req.plan_status,
                    slab_width=group.width, slot=slot, status=st))
                group.clear(slot)
            if group.n_occupied == 0:
                self._teardown(key)
        for c in done:
            self.completed[c.rid] = c
        return done

    def _teardown(self, key: PlanKey) -> None:
        del self._groups[key]
        self.cache.unpin(key)

    def step(self) -> list[Completed]:
        """One scheduling cycle: reap → admit → pack → dispatch → retire.

        Returns the requests that completed this cycle (including ones
        terminated by deadline expiry or cancellation fallout).  With a
        virtual clock, an idle service (nothing queued or resident) jumps
        straight to the next pending arrival instead of spinning.
        """
        self._admit_due()
        if (not self._queue and self.n_in_flight == 0 and self._pending
                and getattr(self.clock, "simulated", False)):
            self.clock.advance_to(self._pending[0].arrival)
            self._admit_due()
        done = self._reap_expired()
        self._pack_queue()
        done.extend(self._dispatch_and_retire())
        return done

    def drain(self, max_steps: int = 100_000) -> list[Completed]:
        """Step until every admitted and pending request has completed."""
        done: list[Completed] = []
        for _ in range(max_steps):
            if not self._queue and not self._pending \
                    and self.n_in_flight == 0:
                return done
            done.extend(self.step())
        raise RuntimeError(
            f"drain did not converge in {max_steps} steps "
            f"({self.n_queued} queued, {self.n_in_flight} in flight)")
