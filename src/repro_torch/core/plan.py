"""Reusable solver plan: factor once, solve many (the setup pipeline).

Port of ``repro.core.plan`` for the single-RHS round-major solve.
``SolverPlan`` owns

    ordering            MC / BMC / HBMC permutation + padded system
    rounds              execution-ordered independent row sets
    IC(0) structure     pattern-only analysis (``ic0_structure``)
    IC(0) factor        round-parallel numeric phase (``ic0_refactor``)
    packed tables       fused round-major tables on the device
    SpMV operand        SELL-w packing of the round-major matrix on the device

``plan.solve(b)`` does no host-side setup: it embeds ``b`` into the
round-major layout, runs the PCG loop on the device (the fused-trisolve and
SELL-w SpMV kernels on the card, their plain versions on the CPU) and
extracts ``x``.  ``plan.refactor(a_new)`` re-runs only the numeric
factorization and repack for a matrix with the same sparsity pattern.

The plan runs on the device it is given (default ``"cuda"``, which raises
without a CUDA device).  The layout is round-major and the SpMV format
SELL-w, the kernels' formats; the index layout, ELL, the mesh, static
validation, batched and slab solves belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from ..kernels.config import DEFAULT_DEVICE, resolve_device
from . import sell
from .coloring import (_validate_block_size, build_blocks, color_blocks,
                       multicolor_ordering, pad_system)
from .graph import adjacency_lists, level_sets, permute_system
from .hbmc import _validate_w, hbmc_from_bmc, pad_system_hbmc
from .ic0 import FactorBreakdownError, ic0_refactor, ic0_structure
from .iccg import PCGResult, _pcg_device, spmv_sell, status_name
from .trisolve import (DeviceFusedTables, RoundMajorPreconditioner,
                       build_round_major_preconditioner_from_rounds)

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


@dataclasses.dataclass
class ICCGReport:
    method: str
    result: PCGResult       # result.x is in the caller's (original) ordering
    n: int
    n_padded: int
    n_colors: int
    n_rounds: int           # sequential rounds per triangular solve
    setup_seconds: float
    solve_seconds: float
    lane_occupancy: float   # mean live lanes / padded lanes per round
    x: np.ndarray           # solution in ORIGINAL ordering (== result.x)
    # which implementation ran the trisolve / SpMV: "cuda" (the hand-written
    # kernels) or "torch" (their plain versions, on the CPU)
    backend: str = "cuda"
    layout: str = "round_major"
    spmv_backend: str = "cuda"
    scheduler: str = "coloring"


@dataclasses.dataclass
class SetupBreakdown:
    """Host-side setup wall-clock, by pipeline stage (seconds).

    ``ordering`` splits further: ``block_build`` is the BMC block growth,
    ``color`` the quotient-graph coloring, ``aggregate`` the HBMC level-1
    interleaving, ``schedule`` the level-set sweep of
    ``scheduler="levelset"`` plans.  Stages a plan does not run stay 0.0.
    """
    ordering: float
    factor: float           # IC(0): structure analysis + numeric phase
    pack: float             # step packing + fuse + SpMV operand + transfer
    total: float
    block_build: float = 0.0
    color: float = 0.0
    aggregate: float = 0.0
    schedule: float = 0.0


@dataclasses.dataclass
class _System:
    """Ordered/padded system plus everything needed to run + undo it."""
    a_bar: sp.csr_matrix
    b_bar: np.ndarray | None
    perm: np.ndarray        # original index -> padded-ordered index
    n: int
    n_padded: int
    n_colors: int
    fwd_rounds: list
    bwd_rounds: list
    drop: np.ndarray | None
    # re-applies the SAME ordering to a new matrix (refactor path)
    apply_ordering: Callable[[sp.spmatrix], sp.csr_matrix] | None = None
    # per-stage wall clock of the ordering pipeline (SetupBreakdown keys)
    ordering_stages: dict[str, float] | None = None


# Round-schedule backends behind ``build_plan(scheduler=...)``; both fill the
# same fwd/bwd-rounds contract of ``_System`` (bwd is the reversed fwd list).
SCHEDULERS = ("coloring", "levelset")


def _levelset_rounds(a_bar: sp.spmatrix) -> tuple[list, list, float]:
    """Replace color rounds with dependency-level rounds on ``a_bar``."""
    t0 = time.perf_counter()
    level, counts = level_sets(a_bar)
    fwd = sell.rounds_levelset(level, counts)
    return fwd, fwd[::-1], time.perf_counter() - t0


def _order_system(a: sp.csr_matrix, b: np.ndarray | None, method: str,
                  block_size: int, w: int,
                  scheduler: str = "coloring") -> _System:
    n = a.shape[0]
    stages: dict[str, float] = {}

    def _bmc_stages():
        # one symmetrized adjacency serves the block build and the
        # quotient-graph contraction
        t0 = time.perf_counter()
        adjacency = adjacency_lists(a)
        part = build_blocks(a, block_size, adjacency=adjacency)
        t1 = time.perf_counter()
        bmc = color_blocks(a, part, block_size, adjacency=adjacency)
        stages["block_build"] = t1 - t0
        stages["color"] = time.perf_counter() - t1
        return bmc

    if method == "mc":
        mc = multicolor_ordering(a)
        a_bar, b_bar = permute_system(a, b, mc.perm)
        sysd = _System(a_bar, b_bar, mc.perm, n, n, mc.n_colors,
                       sell.rounds_mc(mc, reverse=False),
                       sell.rounds_mc(mc, reverse=True), None,
                       lambda a2: permute_system(a2, None, mc.perm)[0])
    elif method == "bmc":
        bmc = _bmc_stages()
        a_bar, b_bar = pad_system(a, b, bmc)
        sysd = _System(a_bar, b_bar, bmc.perm, n, bmc.n_padded, bmc.n_colors,
                       sell.rounds_bmc(bmc, reverse=False),
                       sell.rounds_bmc(bmc, reverse=True), bmc.is_dummy,
                       lambda a2: pad_system(a2, None, bmc)[0])
    elif method == "hbmc":
        bmc = _bmc_stages()
        t0 = time.perf_counter()
        hb = hbmc_from_bmc(bmc, w)
        stages["aggregate"] = time.perf_counter() - t0
        a_bar, b_bar = pad_system_hbmc(a, b, hb)
        sysd = _System(a_bar, b_bar, hb.perm, n, hb.n_final, hb.n_colors,
                       sell.rounds_hbmc(hb, reverse=False),
                       sell.rounds_hbmc(hb, reverse=True), hb.is_dummy,
                       lambda a2: pad_system_hbmc(a2, None, hb)[0])
    elif method == "natural":
        sysd = _System(a, b, np.arange(n), n, n, n,
                       sell.rounds_natural(n, reverse=False),
                       sell.rounds_natural(n, reverse=True), None,
                       lambda a2: sp.csr_matrix(a2))
    else:
        raise ValueError(f"unknown method {method!r}")

    if scheduler == "levelset":
        # keep the method's ordering/padding but re-derive the rounds from
        # the dependency levels of the ordered pattern
        fwd, bwd, secs = _levelset_rounds(sysd.a_bar)
        sysd.fwd_rounds, sysd.bwd_rounds = fwd, bwd
        stages["schedule"] = secs
    elif scheduler != "coloring":
        raise ValueError(f"unknown scheduler {scheduler!r}; expected one "
                         f"of {SCHEDULERS}")
    sysd.ordering_stages = stages
    return sysd


# Manteuffel-style shift escalation (on_breakdown="escalate"): retry the
# numeric sweep with shift + extra, doubling `extra` from _ESCALATION_START,
# until the factor is clean or the attempt budget runs out.
_ESCALATION_START = 1e-3
_MAX_ESCALATIONS = 16
ON_BREAKDOWN = ("clamp", "raise", "escalate")


def _occupancy_from_rounds(rounds, drop) -> float:
    if drop is not None:
        rounds = [r[~drop[r]] for r in rounds]
        rounds = [r for r in rounds if len(r)]
    live = np.array([len(r) for r in rounds], dtype=np.float64)
    rmax = live.max(initial=1.0)
    return float(np.mean(live / rmax)) if len(live) else 1.0


def _check_unported(layout: str, spmv_format: str, validate: str,
                    mesh) -> None:
    """Options of the reference plan that later slices of the port add."""
    if layout != "round_major":
        raise ValueError(f"layout={layout!r} is not ported; the port runs "
                         "layout='round_major'")
    if spmv_format != "sell":
        raise ValueError(f"spmv_format={spmv_format!r} is not ported; the "
                         "port runs spmv_format='sell'")
    if validate != "off":
        raise ValueError(f"validate={validate!r} is not ported; the port "
                         "runs validate='off'")
    if mesh is not None:
        raise ValueError("mesh= is not ported; the port runs on one device")


class SolverPlan:
    """Factor-once / solve-many ICCG plan (see module docstring).

    Build with ``build_plan(a, ...)``, or with ``SolverPlan.from_arrays``
    from packed tables made elsewhere.  ``setup_count`` counts host-side
    setup passes (the initial build and every ``refactor``); ``solve`` never
    changes it.
    """

    def __init__(self, a: sp.spmatrix, method: str = "hbmc",
                 block_size: int = 32, w: int = 8, shift: float = 0.0,
                 spmv_format: str = "sell",
                 dtype: torch.dtype = torch.float64,
                 layout: str = "round_major", mesh=None,
                 on_breakdown: str = "clamp",
                 validate: str = "off", scheduler: str = "coloring",
                 device: str | torch.device = DEFAULT_DEVICE):
        device = resolve_device(device)
        _check_unported(layout, spmv_format, validate, mesh)
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; expected "
                             f"one of {SCHEDULERS}")
        # fail fast with the argument's name, before any ordering work
        block_size = _validate_block_size(block_size, "build_plan")
        w = _validate_w(w, "build_plan")
        if on_breakdown not in ON_BREAKDOWN:
            raise ValueError(f"unknown on_breakdown {on_breakdown!r}; "
                             f"expected one of {ON_BREAKDOWN}")
        self._init_common(device, dtype)
        self.method = method
        self.scheduler = scheduler
        self.block_size = block_size
        self.w = w
        self.shift = shift
        self.on_breakdown = on_breakdown
        # factor-health record, refreshed by every _factor pass
        self.effective_shift = shift
        self.clamped_pivots = 0
        self.shift_schedule: list[tuple[float, int]] = []

        a = sp.csr_matrix(a)
        a.sort_indices()
        # original pattern kept for the refactor structure check
        self._a_indptr = a.indptr.copy()
        self._a_indices = a.indices.copy()

        t0 = time.perf_counter()
        self._sysd = _order_system(a, None, method, block_size, w,
                                   scheduler=scheduler)
        self.n, self.n_padded = self._sysd.n, self._sysd.n_padded
        self.n_colors = self._sysd.n_colors
        self._perm = self._sysd.perm
        t1 = time.perf_counter()
        self._structure = ic0_structure(self._sysd.a_bar,
                                        self._sysd.fwd_rounds)
        l_bar = self._factor(self._sysd.a_bar)
        t2 = time.perf_counter()
        self._build_operators(l_bar)
        t3 = time.perf_counter()
        self.timings = SetupBreakdown(ordering=t1 - t0, factor=t2 - t1,
                                      pack=t3 - t2, total=t3 - t0,
                                      **(self._sysd.ordering_stages or {}))
        self.setup_count += 1
        self.lane_occupancy = _occupancy_from_rounds(self._sysd.fwd_rounds,
                                                     self._sysd.drop)

    def _init_common(self, device: torch.device, dtype: torch.dtype) -> None:
        if dtype not in _NP_DTYPES:
            raise TypeError(f"dtype must be torch.float64 or torch.float32, "
                            f"got {dtype}")
        self.device = device
        self.dtype = dtype
        self._np_dtype = np.dtype(_NP_DTYPES[dtype])
        self.spmv_format = "sell"
        self.layout = "round_major"
        self.setup_count = 0
        self.refactor_count = 0

    @classmethod
    def from_arrays(cls, arrays: dict,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> "SolverPlan":
        """A plan over packed tables made elsewhere (no setup runs).

        ``arrays`` holds numpy arrays / ints under these keys:

          cols, vals, dinv      fused round-major tables (2S, R, K) / (2S, R)
          rows, pos, n_slots    the ``RoundMajorLayout``
          sell_vals, sell_cols  SELL-w operand of the round-major matrix
          sell_n                its dimension (the SpMV result is cut to it)
          perm, n, n_padded     original index -> ordered index, and sizes

        and optionally ``method`` and ``n_colors`` for the report.  The
        plan's dtype is that of ``vals``.  It can solve but not
        ``refactor``: the setup state it would renew was never built here.
        """
        device = resolve_device(device)
        t0 = time.perf_counter()
        plan = cls.__new__(cls)
        vals_dtype = np.asarray(arrays["vals"]).dtype
        plan._init_common(device, {np.dtype(v): k for k, v in
                                   _NP_DTYPES.items()}.get(vals_dtype))
        plan.method = str(arrays.get("method", "unknown"))
        plan.scheduler = "coloring"
        plan.n, plan.n_padded = int(arrays["n"]), int(arrays["n_padded"])
        plan.n_colors = int(arrays.get("n_colors", 0))
        plan._perm = np.asarray(arrays["perm"])
        plan._sysd = None
        plan._rm = sell.RoundMajorLayout(
            rows=np.asarray(arrays["rows"], dtype=np.int32),
            pos=np.asarray(arrays["pos"], dtype=np.int64),
            n_slots=int(arrays["n_slots"]))
        plan._precond = RoundMajorPreconditioner(
            tables=DeviceFusedTables.from_arrays(
                arrays["cols"], arrays["vals"], arrays["dinv"], plan.dtype,
                device))
        plan._set_spmv_operand(arrays["sell_vals"], arrays["sell_cols"],
                               int(arrays["sell_n"]))
        live = (plan._rm.rows != plan._rm.n_slots - 1).sum(axis=1)
        live = live[live > 0].astype(np.float64)
        plan.lane_occupancy = (float(np.mean(live / live.max()))
                               if len(live) else 1.0)
        t1 = time.perf_counter()
        plan.timings = SetupBreakdown(ordering=0.0, factor=0.0,
                                      pack=t1 - t0, total=t1 - t0)
        plan.setup_count = 1
        return plan

    # -- derived properties -------------------------------------------------

    @property
    def n_rounds(self) -> int:
        return self._precond.n_rounds

    @property
    def kernel_backend(self) -> str:
        """"cuda" on the card (hand-written kernels), "torch" on the CPU."""
        return "cuda" if self.device.type == "cuda" else "torch"

    # -- setup internals ----------------------------------------------------

    def _set_spmv_operand(self, vals: np.ndarray, cols: np.ndarray,
                          n: int) -> None:
        self._spmv_vals = torch.tensor(np.asarray(vals),
                                       device=self.device).to(self.dtype)
        self._spmv_cols = torch.tensor(np.asarray(cols, dtype=np.int32),
                                       device=self.device)
        self._spmv_n = n

    def _build_operators(self, l_bar) -> None:
        """Pack the factor + the SELL-w operand and move them to the device."""
        self._precond, self._rm = build_round_major_preconditioner_from_rounds(
            l_bar, self._sysd.fwd_rounds, self._sysd.bwd_rounds,
            drop_mask=self._sysd.drop, dtype=self.dtype, device=self.device)
        a_op = sell.permute_round_major(self._sysd.a_bar, self._rm)
        sm = sell.pack_sell(a_op, self.w)
        self._set_spmv_operand(sm.vals, sm.cols, sm.n)

    def _factor(self, a_bar: sp.csr_matrix) -> sp.csr_matrix:
        """Numeric IC(0) sweep under the plan's ``on_breakdown`` policy.

        A factor is *clean* when no diagonal pivot hit the breakdown guard
        and every entry is finite.  On a dirty factor ``"clamp"`` keeps the
        eps-clamped factor and records ``clamped_pivots``; ``"raise"`` raises
        :class:`FactorBreakdownError`; ``"escalate"`` retries with ``shift +
        extra`` for doubling ``extra`` until clean, and raises if the
        attempt budget runs out or the matrix itself is non-finite.  Every
        attempt is appended to ``self.shift_schedule`` as ``(shift,
        clamped_pivots)``.
        """
        if not np.isfinite(a_bar.data).all():
            raise FactorBreakdownError(
                "matrix values are not finite; no diagonal shift can "
                "repair a NaN/Inf operand", shift_schedule=[])
        l_bar = ic0_refactor(self._structure, a_bar, shift=self.shift)
        clamped = int(getattr(l_bar, "clamped_pivots", 0))
        schedule = [(float(self.shift), clamped)]
        self.shift_schedule = schedule
        if clamped == 0 or self.on_breakdown == "clamp":
            self.effective_shift = self.shift
            self.clamped_pivots = clamped
            return l_bar
        if self.on_breakdown == "raise":
            raise FactorBreakdownError(
                f"IC(0) breakdown: {clamped} pivot(s) clamped at shift="
                f"{self.shift} (on_breakdown='raise'); retry with a larger "
                f"shift or on_breakdown='escalate'",
                clamped_pivots=clamped, shift_schedule=schedule)
        extra = _ESCALATION_START
        for _ in range(_MAX_ESCALATIONS):
            trial = float(self.shift) + extra
            l_bar = ic0_refactor(self._structure, a_bar, shift=trial)
            clamped = int(getattr(l_bar, "clamped_pivots", 0))
            schedule.append((trial, clamped))
            if clamped == 0:
                self.effective_shift = trial
                self.clamped_pivots = 0
                return l_bar
            extra *= 2.0
        raise FactorBreakdownError(
            f"IC(0) breakdown persists after {_MAX_ESCALATIONS} shift "
            f"escalations (last shift {schedule[-1][0]}, "
            f"{schedule[-1][1]} clamped pivot(s))",
            clamped_pivots=clamped, shift_schedule=schedule)

    def refactor(self, a_new: sp.spmatrix) -> SetupBreakdown:
        """Renew the factorization for a structure-identical matrix.

        Re-runs the value-dependent pipeline (permute values, IC(0) numeric
        phase over the cached structure, repack, transfer) while ordering,
        rounds, layout and the IC(0) symbolic analysis stay cached.  Raises
        ValueError if ``a_new``'s sparsity pattern differs.
        """
        if self._sysd is None:
            raise ValueError("a plan made by from_arrays has no setup state "
                             "to refactor; build it with build_plan")
        a_new = sp.csr_matrix(a_new)
        a_new.sort_indices()
        if (a_new.shape[0] != self.n
                or not np.array_equal(a_new.indptr, self._a_indptr)
                or not np.array_equal(a_new.indices, self._a_indices)):
            raise ValueError("refactor requires a structure-identical "
                             "matrix (same sparsity pattern); build a new "
                             "plan instead")
        t0 = time.perf_counter()
        a_bar = self._sysd.apply_ordering(a_new)
        # factor BEFORE mutating plan state: a FactorBreakdownError from the
        # on_breakdown policy leaves the old (working) operators in place
        l_bar = self._factor(a_bar)
        self._sysd.a_bar = a_bar
        t1 = time.perf_counter()
        self._build_operators(l_bar)
        t2 = time.perf_counter()
        self.setup_count += 1
        self.refactor_count += 1
        return SetupBreakdown(ordering=0.0, factor=t1 - t0, pack=t2 - t1,
                              total=t2 - t0)

    # -- solving ------------------------------------------------------------

    def _spmv(self, x: torch.Tensor) -> torch.Tensor:
        return spmv_sell(self._spmv_vals, self._spmv_cols, x, self._spmv_n)

    def _embed(self, b_bar: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(self._rm.embed(b_bar), device=self.device)

    def _extract(self, x_dev: torch.Tensor) -> np.ndarray:
        return np.asarray(self._rm.extract(x_dev.cpu().numpy())[self._perm])

    def solve(self, b: np.ndarray, rtol: float = 1e-7,
              maxiter: int = 10_000,
              record_history: bool = False) -> ICCGReport:
        """Solve A x = b reusing every cached setup product.

        Per-call host work is exactly: embed ``b`` into the solve layout,
        extract ``x`` back into the caller's ordering.
        """
        t0 = time.perf_counter()
        b = np.asarray(b, dtype=self._np_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"plan.solve expects b of shape ({self.n},), "
                             f"got {b.shape}")
        b_bar = np.zeros(self.n_padded, dtype=self._np_dtype)
        b_bar[self._perm] = b
        b_dev = self._embed(b_bar)
        t1 = time.perf_counter()
        x, it, relres, status, hist = _pcg_device(
            self._spmv, self._precond, b_dev, rtol=rtol, maxiter=maxiter,
            record_history=record_history)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        x_out = self._extract(x)
        relres = float(relres)
        res = PCGResult(x=x_out, iterations=int(it), relres=relres,
                        converged=relres < rtol, history=hist.cpu().numpy(),
                        status=status_name(status))
        return ICCGReport(
            method=self.method, result=res, n=self.n,
            n_padded=self.n_padded, n_colors=self.n_colors,
            n_rounds=self.n_rounds, setup_seconds=t1 - t0,
            solve_seconds=t2 - t1, lane_occupancy=self.lane_occupancy,
            x=x_out, backend=self.kernel_backend, layout=self.layout,
            spmv_backend=self.kernel_backend, scheduler=self.scheduler)


def build_plan(a: sp.spmatrix, method: str = "hbmc", block_size: int = 32,
               w: int = 8, shift: float = 0.0, spmv_format: str = "sell",
               dtype: torch.dtype = torch.float64,
               layout: str = "round_major", mesh=None,
               on_breakdown: str = "clamp",
               validate: str = "off", scheduler: str = "coloring",
               device: str | torch.device = DEFAULT_DEVICE) -> SolverPlan:
    """One-time setup: ordering -> round-parallel IC(0) -> packed operators.

    Returns a ``SolverPlan`` whose ``solve`` / ``refactor`` amortize this
    cost over many solves.  ``device`` is where the PCG loop runs:
    ``"cuda"`` (the default; raises without a CUDA device) launches the
    hand-written kernels, ``"cpu"`` runs their plain PyTorch versions.

    ``scheduler`` picks how the ordered pattern is cut into parallel rounds:
    ``"coloring"`` uses the method's color rounds, ``"levelset"`` the
    dependency levels of the ordered pattern.
    """
    return SolverPlan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      layout=layout, mesh=mesh, on_breakdown=on_breakdown, validate=validate,
                      scheduler=scheduler, device=device)
