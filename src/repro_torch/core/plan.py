"""Reusable solver plan: factor once, solve many (the setup pipeline).

Port of ``repro.core.plan``: single-RHS, batched multi-RHS and the slab
primitives of the serving layer, in both layouts, on one device or, for
the round-major layout, sharded over one axis of a ``torch.distributed``
``DeviceMesh``.
``SolverPlan`` owns

    ordering            MC / BMC / HBMC permutation + padded system
    rounds              execution-ordered independent row sets
    IC(0) structure     pattern-only analysis (``ic0_structure``)
    IC(0) factor        round-parallel numeric phase (``ic0_refactor``)
    packed tables       fused round-major tables (``layout="round_major"``)
                        or one round-major table per sweep
                        (``layout="index"``), on the device
    SpMV operand        SELL-w or ELL packing of the matrix in the solve
                        layout, on the device
    PCG loops           one ``device_loop.BlockLoop`` per (loop, rtol,
                        maxiter, record_history, divergence_factor,
                        stagnation_window, steps per read[, slab width])
                        signature in ``_pcg_cache``: on the card the CUDA
                        graph of a block of PCG steps, captured at the
                        signature's first solve and replayed after

``plan.solve(b)`` does no host-side setup: it embeds ``b`` into the solve
layout, runs the PCG loop on the device (the trisolve and SELL-w SpMV
kernels on the card, their plain versions on the CPU) and extracts ``x``.
``plan.solve_batched(B)`` does the same for the columns of an (n, B)
block in one loop (the batched kernels), and ``new_slab_state`` /
``run_slab`` / ``solve_slab`` are the resident-slab primitives that
``repro_torch.serve`` drives.  ``plan.refactor(a_new)`` re-runs only the
numeric factorization and repack for a matrix with the same sparsity
pattern, and writes the new values into the device tensors the captured
graphs read, so no graph is captured again.

The plan runs on the device it is given (default ``"cuda"``, which raises
without a CUDA device), or on the mesh's device type.  Under a mesh every
rank runs the same program (SPMD): it builds the plan from the same matrix,
keeps its lane block of the fused tables and its slice block of the SpMV
operand on its device, and solves the same right-hand side with replicated
state vectors; the preconditioner issues one all-gather per fused step and
the SpMV one per product (``DistributedRoundMajorPreconditioner``,
``make_sharded_spmv``).

``validate`` (``"off"`` by default) runs the static race detector of
``repro_torch.analysis`` before the plan is handed out, as the reference
does; see ``build_plan``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..kernels.config import DEFAULT_DEVICE, resolve_device
from ..spans import span
from . import sell
from .coloring import (_validate_block_size, build_blocks, color_blocks,
                       multicolor_ordering, pad_system)
from .device_loop import LoopCache
from .graph import adjacency_lists, level_sets, permute_system
from .hbmc import _validate_w, hbmc_from_bmc, pad_system_hbmc
from .ic0 import FactorBreakdownError, ic0_refactor, ic0_structure
from .iccg import (DIVERGENCE_FACTOR, STAGNATION_WINDOW, BatchedPCGResult,
                   PCGResult, SlabState, _pcg_batched_device, _pcg_device,
                   _pcg_slab_device, make_sharded_spmv, spmv_ell,
                   spmv_ell_batched, spmv_sell, spmv_sell_batched,
                   status_name)
from .mesh import axis_group, axis_names
from .trisolve import (LAYOUTS, DeviceFusedTables,
                       DistributedRoundMajorPreconditioner,
                       RoundMajorPreconditioner, _assemble_preconditioner,
                       build_round_major_preconditioner_from_rounds,
                       shard_fused_tables)

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}
SPMV_FORMATS = ("sell", "ell")


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
class BatchedICCGReport:
    method: str
    result: BatchedPCGResult  # result.x is (n, B) in the caller's ordering
    n: int
    n_padded: int
    n_colors: int
    n_rounds: int
    setup_seconds: float
    solve_seconds: float
    lane_occupancy: float
    x: np.ndarray           # (n, B) solutions in ORIGINAL ordering
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


def _check_knobs(layout: str, spmv_format: str, validate: str) -> None:
    """Unknown layouts, formats and validate modes raise, as in the
    reference."""
    # deferred, as in the reference: the analysis package imports core
    from ..analysis.schedule import check_validate_mode
    check_validate_mode(validate)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")
    if spmv_format not in SPMV_FORMATS:
        raise ValueError(f"unknown spmv_format {spmv_format!r}; expected "
                         f"one of {SPMV_FORMATS}")


def _check_mesh(mesh, mesh_axis: str, layout: str, lane_multiple: int,
                device) -> tuple[torch.device, int]:
    """The plan's device and lane multiple, with the reference's mesh
    checks: a mesh needs the round-major layout and an axis it has, and its
    axis size is folded into ``lane_multiple``.  The device is the mesh's
    device type; an explicit ``device`` of another type raises."""
    lane_multiple = max(int(lane_multiple), 1)
    if mesh is None:
        return resolve_device(DEFAULT_DEVICE if device is None else device), \
            lane_multiple
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if layout != "round_major":
        raise ValueError("mesh= requires layout='round_major' (the sharded "
                         "apply is the fused round-major sweep)")
    if mesh_axis not in axis_names(mesh):
        raise ValueError(f"mesh has no axis {mesh_axis!r}; axes are "
                         f"{axis_names(mesh)}")
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device={str(device)!r} disagrees with the mesh's "
                         f"device type {mesh.device_type!r}")
    # the lane axis must shard evenly: fold the axis size into the lane
    # padding (a single-device plan with the same lane_multiple is bitwise
    # identical, the parity oracle of the tests)
    size = axis_group(mesh, mesh_axis)[1]
    return resolve_device(mesh.device_type), \
        int(np.lcm(lane_multiple, size))


def _shard_rows(vals: np.ndarray, cols: np.ndarray, size: int, rank: int,
                pad: bool) -> tuple[np.ndarray, np.ndarray]:
    """This rank's block of a packed SpMV operand's leading axis.  ``pad``
    (SELL) first pads the axis with all-zero slices to a multiple of
    ``size``: they give rows past n, which the SpMV cuts."""
    extra = (-vals.shape[0]) % size
    if extra and pad:
        widths = ((0, extra),) + ((0, 0),) * (vals.ndim - 1)
        vals, cols = np.pad(vals, widths), np.pad(cols, widths)
    elif extra:
        raise ValueError(f"{vals.shape[0]} operand rows do not split over "
                         f"{size} ranks")
    block = vals.shape[0] // size
    rows = slice(rank * block, (rank + 1) * block)
    return vals[rows], cols[rows]


def _keep_entries(a: sp.csr_matrix, kept: np.ndarray) -> sp.csr_matrix:
    """A new CSR matrix of the stored entries of ``a`` where ``kept``
    holds, zeros among them included."""
    before = np.concatenate([[0], np.cumsum(kept)])   # kept before each
    indptr = before[a.indptr].astype(a.indptr.dtype)
    return sp.csr_matrix((a.data[kept], a.indices[kept], indptr),
                         shape=a.shape)


def _drop_stored_zeros(a: sp.csr_matrix
                       ) -> tuple[sp.csr_matrix, np.ndarray | None]:
    """``a`` without its stored exact zeros, and which stored entries were
    kept; ``a`` itself and None where it stores none.

    The ordering's graph sees only nonzeros, the IC(0) structure every
    stored entry: a stored zero joining two rows that the ordering put in
    one round would leave the rounds not dependency-ordered (``ic0``
    raises).  With the zeros dropped once, before the ordering, the
    ordering, the factor and the SpMV see one pattern."""
    kept = a.data != 0
    if kept.all():
        return a, None
    return _keep_entries(a, kept), kept


def _upload(host: np.ndarray, device: torch.device,
            moved: span | None = None) -> torch.Tensor:
    """``host`` as a tensor on ``device``; the bytes that cross to the
    device, none on the CPU, are added to ``moved.nbytes``."""
    if moved is not None and device.type != "cpu":
        moved.nbytes += host.nbytes
    return torch.as_tensor(host, device=device)


def _download(t: torch.Tensor, moved: span | None = None) -> torch.Tensor:
    """``t`` on the host; the bytes that cross, none from the CPU, are
    added to ``moved.nbytes``."""
    if moved is not None and t.device.type != "cpu":
        moved.nbytes += t.nbytes
    return t.cpu()


class SolverPlan:
    """Factor-once / solve-many ICCG plan (see module docstring).

    Build with ``build_plan(a, ...)``, or with ``SolverPlan.from_arrays``
    from packed tables made elsewhere.  ``setup_count`` counts host-side
    setup passes (the initial build and every ``refactor``); ``solve`` never
    changes it.  ``_capture_count`` counts the CUDA graphs captured for
    the PCG loops (the reference's ``_trace_count``): one per signature,
    none added by a warm solve or by ``refactor``.
    """

    def __init__(self, a: sp.spmatrix, method: str = "hbmc",
                 block_size: int = 32, w: int = 8, shift: float = 0.0,
                 spmv_format: str = "sell",
                 dtype: torch.dtype = torch.float64,
                 layout: str = "round_major", mesh: DeviceMesh | None = None,
                 mesh_axis: str = "data", lane_multiple: int = 1,
                 on_breakdown: str = "clamp",
                 validate: str = "off", scheduler: str = "coloring",
                 device: str | torch.device | None = None):
        _check_knobs(layout, spmv_format, validate)
        device, lane_multiple = _check_mesh(mesh, mesh_axis, layout,
                                            lane_multiple, device)
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
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.lane_multiple = lane_multiple
        self.layout = layout
        self.spmv_format = spmv_format
        self.method = method
        self.scheduler = scheduler
        self.block_size = block_size
        self.w = w
        self.shift = shift
        self.on_breakdown = on_breakdown
        self.validate = validate
        # factor-health record, refreshed by every _factor pass
        self.effective_shift = shift
        self.clamped_pivots = 0
        self.shift_schedule: list[tuple[float, int]] = []

        a = sp.csr_matrix(a)
        a.sort_indices()
        # original pattern kept for the refactor structure check
        self._a_indptr = a.indptr.copy()
        self._a_indices = a.indices.copy()
        a, self._kept = _drop_stored_zeros(a)

        with span("build") as build:
            with span("build.ordering") as ordering:
                self._sysd = _order_system(a, None, method, block_size, w,
                                           scheduler=scheduler)
                self.n, self.n_padded = self._sysd.n, self._sysd.n_padded
                self.n_colors = self._sysd.n_colors
                self._perm = self._sysd.perm
            with span("build.factor") as factor:
                self._structure = ic0_structure(self._sysd.a_bar,
                                                self._sysd.fwd_rounds)
                l_bar = self._factor(self._sysd.a_bar)
            with span("build.pack") as pack:
                held = self._build_operators(l_bar)
                if validate != "off":
                    # static race proof BEFORE the plan is handed out:
                    # "cheap" is the O(nnz) round-monotonicity scan, "full"
                    # additionally proves the tables the kernels launch,
                    # their segment cuts and the IC(0) step schedule
                    # (raises ScheduleError with the offending witness)
                    from ..analysis.schedule import assert_plan_valid
                    assert_plan_valid(
                        self, validate, tables=held,
                        context=f"build_plan(method={method!r})")
        self.timings = SetupBreakdown(ordering=ordering.seconds,
                                      factor=factor.seconds,
                                      pack=pack.seconds, total=build.seconds,
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
        self.mesh, self.mesh_axis, self.lane_multiple = None, "data", 1
        self._np_dtype = np.dtype(_NP_DTYPES[dtype])
        self.setup_count = 0
        self.refactor_count = 0
        self._pcg_cache = LoopCache()

    @property
    def _capture_count(self) -> int:
        return self._pcg_cache.captures

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
        plan's dtype is that of ``vals``; its layout is round-major and its
        SpMV format SELL-w (the tables above are theirs).  It can solve but
        not ``refactor``: the setup state it would renew was never built
        here.
        """
        device = resolve_device(device)
        with span("build") as build, span("build.pack") as pack:
            plan = cls.__new__(cls)
            vals_dtype = np.asarray(arrays["vals"]).dtype
            plan._init_common(device, {np.dtype(v): k for k, v in
                                       _NP_DTYPES.items()}.get(vals_dtype))
            plan.layout, plan.spmv_format = "round_major", "sell"
            plan.method = str(arrays.get("method", "unknown"))
            plan.scheduler = "coloring"
            plan.validate = "off"
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
                    arrays["cols"], arrays["vals"], arrays["dinv"],
                    plan.dtype, device))
            plan._set_spmv_operand(arrays["sell_vals"], arrays["sell_cols"],
                                   int(arrays["sell_n"]))
            live = (plan._rm.rows != plan._rm.n_slots - 1).sum(axis=1)
            live = live[live > 0].astype(np.float64)
            plan.lane_occupancy = (float(np.mean(live / live.max()))
                                   if len(live) else 1.0)
        plan.timings = SetupBreakdown(ordering=0.0, factor=0.0,
                                      pack=pack.seconds, total=build.seconds)
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

    def _step_tables(self) -> list:
        """The preconditioner's device step tables: the fused table of the
        round-major layout, or the index layout's forward and backward
        sweeps."""
        if self.layout == "round_major":
            return [self._precond.tables]
        return [self._precond.kernel.fwd, self._precond.kernel.bwd]

    def _build_operators(self, l_bar) -> dict:
        """Pack the factor + the SpMV operand in the plan's layout and
        format, and move them to the device.  The index layout has no
        round-major state map (``_rm`` is None): its vectors are in HBMC
        order, of length ``n_padded``.  Under a mesh the plan keeps this
        rank's lane block of the fused tables and its block of the SpMV
        operand's rows (ELL) or slices (SELL, padded with zero slices to a
        multiple of the axis size).

        Returns what ``analysis.validate_plan`` reads of the build and the
        plan does not keep: the index layout's host ``StepTables``
        (``"fwd"``, ``"bwd"``) and a mesh plan's whole fused tables before
        they were sharded (``"fused"``)."""
        sysd = self._sysd
        held = {}
        if self.layout == "round_major":
            self._precond, self._rm = \
                build_round_major_preconditioner_from_rounds(
                    l_bar, sysd.fwd_rounds, sysd.bwd_rounds,
                    drop_mask=sysd.drop, dtype=self.dtype,
                    device=self.device, lane_multiple=self.lane_multiple)
            a_op = sell.permute_round_major(sysd.a_bar, self._rm)
        else:
            held["fwd"], held["bwd"] = sell.pack_factor(
                l_bar, sysd.fwd_rounds, sysd.bwd_rounds, sysd.drop)
            self._precond = _assemble_preconditioner(
                held["fwd"], held["bwd"], l_bar.shape[0], self.dtype,
                self.device)
            self._rm = None
            a_op = sysd.a_bar
        if self.spmv_format == "sell":
            sm = sell.pack_sell(a_op, self.w)
            vals, cols, n = sm.vals, sm.cols, sm.n
        else:
            cols, vals = sell.pack_ell(a_op)
            n = a_op.shape[0]
        if self.mesh is not None:
            held["fused"] = self._precond.tables
            self._precond = DistributedRoundMajorPreconditioner(
                tables=shard_fused_tables(self._precond.tables, self.mesh,
                                          self.mesh_axis),
                mesh=self.mesh, axis=self.mesh_axis)
            _, size, rank = axis_group(self.mesh, self.mesh_axis)
            vals, cols = _shard_rows(vals, cols, size, rank,
                                     pad=self.spmv_format == "sell")
        self._set_spmv_operand(vals, cols, n)
        return held

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
        rounds, layout and the IC(0) symbolic analysis stay cached.  Where
        the repacked index tensors are unchanged (a structure-identical
        matrix gives the same ones) the new factor and SpMV values are
        written in place into the device tensors the captured PCG graphs
        read, and the step tables keep their barrier-free segments;
        otherwise the new tensors replace them and ``_pcg_cache`` is
        cleared, as the reference clears its closed-over jits.  Raises
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
        if self._kept is not None:
            if np.any(a_new.data[~self._kept] != 0):
                raise ValueError("refactor requires zeros where the plan's "
                                 "matrix stored zeros (its set-up dropped "
                                 "them); build a new plan instead")
            a_new = _keep_entries(a_new, self._kept)
        with span("build") as build:
            with span("build.factor") as factor:
                a_bar = self._sysd.apply_ordering(a_new)
                # factor BEFORE mutating plan state: a FactorBreakdownError
                # from the on_breakdown policy leaves the old (working)
                # operators in place
                l_bar = self._factor(a_bar)
                self._sysd.a_bar = a_bar
            with span("build.pack") as pack:
                old = (self._precond, self._rm, self._spmv_vals,
                       self._spmv_cols)
                old_tables = self._step_tables()
                self._build_operators(l_bar)
                if self._same_indices(old_tables, old[3]):
                    # the captured graphs read the old tensors: the new
                    # values go into them, and the tables keep their
                    # segments
                    for was, now in zip(old_tables, self._step_tables()):
                        was.vals.copy_(now.vals)
                        was.dinv.copy_(now.dinv)
                    old[2].copy_(self._spmv_vals)
                    (self._precond, self._rm, self._spmv_vals,
                     self._spmv_cols) = old
                else:
                    for was, now in zip(old_tables, self._step_tables()):
                        if "segments" in vars(was) and torch.equal(
                                was.cols, now.cols):
                            now.segments = was.segments
                    # new operand addresses: recapture
                    self._pcg_cache.clear()
        self.setup_count += 1
        self.refactor_count += 1
        return SetupBreakdown(ordering=0.0, factor=factor.seconds,
                              pack=pack.seconds, total=build.seconds)

    def _same_indices(self, old_tables: list,
                      old_spmv_cols: torch.Tensor) -> bool:
        """Whether the freshly built operators have the old ones' index
        tensors and value shapes, so their values can be written in place."""
        same = torch.equal(old_spmv_cols, self._spmv_cols) and all(
            was.vals.shape == now.vals.shape
            and was.dinv.shape == now.dinv.shape
            and all(torch.equal(getattr(was, f), getattr(now, f))
                    for f in ("cols", "pos", "rows") if hasattr(was, f))
            for was, now in zip(old_tables, self._step_tables()))
        return same and old_spmv_cols.shape == self._spmv_cols.shape

    # -- solving ------------------------------------------------------------

    def _spmv(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return self._sharded_spmv(x, batched=False)
        if self.spmv_format == "ell":
            return spmv_ell(self._spmv_vals, self._spmv_cols, x)
        return spmv_sell(self._spmv_vals, self._spmv_cols, x, self._spmv_n)

    def _sharded_spmv(self, x: torch.Tensor, batched: bool) -> torch.Tensor:
        return make_sharded_spmv(self.spmv_format, self._spmv_n, self.mesh,
                                 self.mesh_axis, self._spmv_vals,
                                 self._spmv_cols, batched)(x)

    def _spmv_batched(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return self._sharded_spmv(x, batched=True)
        if self.spmv_format == "ell":
            return spmv_ell_batched(self._spmv_vals, self._spmv_cols, x)
        return spmv_sell_batched(self._spmv_vals, self._spmv_cols, x,
                                 self._spmv_n)

    def _embed(self, b_bar: np.ndarray,
               moved: span | None = None) -> torch.Tensor:
        """HBMC-ordered (n_padded[, B]) -> a device tensor in the solve
        layout; the upload's bytes go to ``moved.nbytes``."""
        if self._rm is not None:
            b_bar = self._rm.embed(b_bar)
        return _upload(b_bar, self.device, moved)

    def _extract(self, x_dev: torch.Tensor,
                 moved: span | None = None) -> np.ndarray:
        """Solve layout (slab_m[, B]) on the device -> caller's ordering
        (n[, B]); only ``x_dev``'s own elements cross to the host, and
        their bytes go to ``moved.nbytes``."""
        x_bar = _download(x_dev, moved).numpy()
        if self._rm is not None:
            x_bar = self._rm.extract(x_bar)
        return np.asarray(x_bar[self._perm])

    def _check_slab(self, b: np.ndarray, who: str) -> np.ndarray:
        """Validate a multi-RHS slab: 2-D (n, B) with the plan's dtype.

        A 1-D b gets its own error (naming the B=1 spelling) and a float
        dtype mismatch is an error rather than a silent cast: the packed
        operands are ``self.dtype``.
        """
        b = np.asarray(b)
        if b.ndim == 1:
            raise ValueError(
                f"{who} expects b of shape ({self.n}, B), got a 1-D vector "
                f"of shape {b.shape}; pass a single RHS as the one-column "
                f"slab b[:, None] (B = 1), or use plan.solve")
        if b.ndim != 2 or b.shape[0] != self.n:
            raise ValueError(f"{who} expects b of shape "
                             f"({self.n}, B), got {b.shape}")
        if np.issubdtype(b.dtype, np.floating) and b.dtype != self._np_dtype:
            raise TypeError(
                f"{who}: b has dtype {b.dtype} but the plan's packed "
                f"operands are {self._np_dtype}; cast b explicitly "
                f"(b.astype({self._np_dtype})) to opt in")
        return np.asarray(b, dtype=self._np_dtype)

    # -- slab serving primitives (see repro_torch.serve) --------------------

    @property
    def slab_m(self) -> int:
        """Length of a device-side state column in the solve layout."""
        return self._rm.m if self._rm is not None else self.n_padded

    def embed_rhs(self, b: np.ndarray) -> torch.Tensor:
        """Embed one RHS (original ordering, shape (n,)) into a device
        column of the solve layout (shape (slab_m,)): the host half of
        packing a slab slot."""
        b = np.asarray(b, dtype=self._np_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"plan.embed_rhs expects b of shape "
                             f"({self.n},), got {b.shape}")
        b_bar = np.zeros(self.n_padded, dtype=self._np_dtype)
        b_bar[self._perm] = b
        return self._embed(b_bar)

    def extract_solution(self, x_col: torch.Tensor) -> np.ndarray:
        """Undo ``embed_rhs``: a device column (slab_m,), such as
        ``state.x[:, slot]`` -> x in the caller's original ordering (n,)."""
        return self._extract(x_col)

    def new_slab_state(self, slab_width: int) -> SlabState:
        """An all-empty resident slab: every slot fresh with a zero RHS
        (a zero residual initializes inert -- see ``SlabState``).  Every
        field is a tensor of its own, so a slot can be written in place."""
        if slab_width < 1:
            raise ValueError(f"slab_width must be >= 1, got {slab_width}")
        m, dt, dev = self.slab_m, self.dtype, self.device

        def vec(fill, dtype):
            return torch.full((slab_width,), fill, dtype=dtype, device=dev)

        return SlabState(
            x=torch.zeros((m, slab_width), dtype=dt, device=dev),
            r=torch.zeros((m, slab_width), dtype=dt, device=dev),
            p=torch.zeros((m, slab_width), dtype=dt, device=dev),
            rz=vec(0.0, dt), bnorm=vec(1.0, dt),
            active=vec(False, torch.bool), iters=vec(0, torch.int32),
            relres=vec(0.0, dt), fresh=vec(True, torch.bool),
            status=vec(0, torch.int32), best=vec(0.0, dt),
            since_best=vec(0, torch.int32))

    def run_slab(self, state: SlabState, rtol: float = 1e-7,
                 maxiter: int = 10_000, quantum: int = 16,
                 divergence_factor: float | None = DIVERGENCE_FACTOR,
                 stagnation_window: int | None = STAGNATION_WINDOW
                 ) -> tuple[SlabState, int]:
        """Advance a resident slab by at most ``quantum`` PCG iterations.

        Columns flagged ``fresh`` are (re)initialized from their ``r`` at
        entry; continuing columns resume bitwise where they left off.
        Returns ``(new_state, steps_taken)``; every inactive column of the
        new state has a definite ``status``.  ``state`` is not written.
        """
        return _pcg_slab_device(
            self._spmv_batched, self._precond.apply_batched, state,
            rtol=rtol, maxiter=maxiter, quantum=quantum,
            divergence_factor=divergence_factor,
            stagnation_window=stagnation_window, loops=self._pcg_cache)

    def solve_slab(self, b: np.ndarray, slab_width: int = 1,
                   rtol: float = 1e-7, maxiter: int = 10_000,
                   slot: int = 0) -> ICCGReport:
        """Solve one RHS through the slab path at a given resident width.

        Packs ``b`` into ``slot`` of an otherwise empty width-``slab_width``
        slab and runs it to the end in one dispatch.  This is the oracle
        for serving: a column served by ``repro_torch.serve.SolverService``
        at slab width B in slot s is bitwise equal to
        ``plan.solve_slab(b, slab_width=B, slot=s)`` -- slab columns do not
        depend on their neighbours' contents or on dispatch boundaries, but
        (width, slot) may pin the reduction order.  At ``slab_width=1`` it
        is bitwise equal to ``plan.solve_batched(b[:, None])``.  Iteration
        counts equal the single-RHS ``plan.solve`` counts.
        """
        with span("solve.embed") as embed:
            b = np.asarray(b, dtype=self._np_dtype)
            if b.shape != (self.n,):
                raise ValueError(f"plan.solve_slab expects b of shape "
                                 f"({self.n},), got {b.shape}")
            if not 0 <= slot < slab_width:
                raise ValueError(f"slot {slot} out of range for slab_width "
                                 f"{slab_width}")
            state = self.new_slab_state(slab_width)
            b_bar = np.zeros(self.n_padded, dtype=self._np_dtype)
            b_bar[self._perm] = b
            state.r[:, slot] = self._embed(b_bar, embed)  # a state of our own
        with span("solve.loop") as loop:
            state, _ = self.run_slab(state, rtol=rtol, maxiter=maxiter,
                                     quantum=maxiter)
            self._sync()
        with span("solve.extract") as extract:
            x_out = self._extract(state.x[:, slot], extract)
            relres = float(_download(state.relres[slot], extract))
            res = PCGResult(
                x=x_out, iterations=int(_download(state.iters[slot], extract)),
                relres=relres, converged=relres < rtol,
                history=np.zeros((0,)),
                status=status_name(_download(state.status[slot], extract)))
        return self._report(ICCGReport, res, x_out, embed.seconds,
                            loop.seconds)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _report(self, cls, res, x_out, setup_s: float, solve_s: float):
        return cls(
            method=self.method, result=res, n=self.n,
            n_padded=self.n_padded, n_colors=self.n_colors,
            n_rounds=self.n_rounds, setup_seconds=setup_s,
            solve_seconds=solve_s, lane_occupancy=self.lane_occupancy,
            x=x_out, backend=self.kernel_backend, layout=self.layout,
            spmv_backend=self.kernel_backend, scheduler=self.scheduler)

    def solve(self, b: np.ndarray, rtol: float = 1e-7,
              maxiter: int = 10_000,
              record_history: bool = False) -> ICCGReport:
        """Solve A x = b reusing every cached setup product.

        Per-call host work is exactly: embed ``b`` into the solve layout,
        extract ``x`` back into the caller's ordering.
        """
        with span("solve.embed") as embed:
            b = np.asarray(b, dtype=self._np_dtype)
            if b.shape != (self.n,):
                raise ValueError(f"plan.solve expects b of shape ({self.n},), "
                                 f"got {b.shape}")
            b_bar = np.zeros(self.n_padded, dtype=self._np_dtype)
            b_bar[self._perm] = b
            b_dev = self._embed(b_bar, embed)
        with span("solve.loop") as loop:
            x, it, relres, status, hist = _pcg_device(
                self._spmv, self._precond, b_dev, rtol=rtol, maxiter=maxiter,
                record_history=record_history, loops=self._pcg_cache)
            self._sync()
        with span("solve.extract") as extract:
            x_out = self._extract(x, extract)
            relres = float(_download(relres, extract))
            res = PCGResult(x=x_out, iterations=int(_download(it, extract)),
                            relres=relres, converged=relres < rtol,
                            history=_download(hist, extract).numpy(),
                            status=status_name(_download(status, extract)))
        return self._report(ICCGReport, res, x_out, embed.seconds,
                            loop.seconds)

    def solve_batched(self, b: np.ndarray, rtol: float = 1e-7,
                      maxiter: int = 10_000,
                      record_history: bool = False) -> BatchedICCGReport:
        """Solve A x_j = b_j for all columns of ``b`` ((n, B)) in one PCG
        loop, reusing every cached setup product."""
        with span("solve.embed") as embed:
            b = self._check_slab(b, "plan.solve_batched")
            b_bar = np.zeros((self.n_padded, b.shape[1]), dtype=self._np_dtype)
            b_bar[self._perm] = b
            b_dev = self._embed(b_bar, embed)
        with span("solve.loop") as loop:
            x, iters, relres, step, status, hist = _pcg_batched_device(
                self._spmv_batched, self._precond.apply_batched, b_dev,
                rtol=rtol, maxiter=maxiter, record_history=record_history,
                loops=self._pcg_cache)
            self._sync()
        with span("solve.extract") as extract:
            x_out = self._extract(x, extract)
            relres = _download(relres, extract).numpy()
            res = BatchedPCGResult(
                x=x_out, iterations=_download(iters, extract).numpy(),
                relres=relres, converged=relres < rtol, n_steps=step,
                history=_download(hist, extract).numpy(),
                status=_download(status, extract).numpy())
        return self._report(BatchedICCGReport, res, x_out, embed.seconds,
                            loop.seconds)


def build_plan(a: sp.spmatrix, method: str = "hbmc", block_size: int = 32,
               w: int = 8, shift: float = 0.0, spmv_format: str = "sell",
               dtype: torch.dtype = torch.float64,
               layout: str = "round_major", mesh: DeviceMesh | None = None,
               mesh_axis: str = "data", lane_multiple: int = 1,
               on_breakdown: str = "clamp",
               validate: str = "off", scheduler: str = "coloring",
               device: str | torch.device | None = None) -> SolverPlan:
    """One-time setup: ordering -> round-parallel IC(0) -> packed operators.

    Returns a ``SolverPlan`` whose ``solve`` / ``refactor`` amortize this
    cost over many solves.  ``device`` is where the PCG loop runs:
    ``"cuda"`` (the default; raises without a CUDA device) launches the
    hand-written kernels, ``"cpu"`` runs their plain PyTorch versions.

    With ``mesh=`` (a ``torch.distributed.device_mesh.DeviceMesh`` with
    named dimensions, made by the caller with ``init_device_mesh``) the
    plan is distributed over the dimension ``mesh_axis``: every rank calls
    ``build_plan`` with the same matrix and ``solve`` with the same
    right-hand side, and keeps only its block of the fused tables' lanes
    and of the SpMV operand; the apply runs the fused sweep with one
    all-gather per step.  The plan runs on the mesh's device type (a
    ``device`` of another type raises) and needs ``layout="round_major"``.
    ``lane_multiple`` pads the lane axis (folded with the axis size by
    lcm); a single-device plan built with the same ``lane_multiple`` is the
    bitwise parity oracle for a distributed plan.

    ``scheduler`` picks how the ordered pattern is cut into parallel rounds:
    ``"coloring"`` uses the method's color rounds, ``"levelset"`` the
    dependency levels of the ordered pattern.

    Stored exact zeros of ``a`` are dropped, on the plan's own copy, before
    the ordering, so the ordering, the IC(0) factor and the SpMV see one
    pattern; a matrix that stores none gives the same plan as before.  The
    product is unchanged for finite vectors, but a stored 0 times a
    non-finite entry of the vector no longer gives NaN.  ``refactor``
    takes the matrix with the same stored pattern, and zeros where the
    dropped entries were.

    ``validate`` runs the static schedule race detector
    (``repro_torch.analysis``) at setup, as in the reference: ``"cheap"``
    is an O(nnz) round-monotonicity scan of the ordering's rounds,
    ``"full"`` additionally proves the tables the kernels launch (the
    fused table, each sweep's step tables, a mesh plan's whole tables
    before they are sharded and the rank's block of them), every segment
    cut a trisolve kernel launches with (``analysis.check_segments``, the
    card's own race: lanes of one launch run in no order) and the IC(0)
    step schedule; ``"deep"`` adds the kernel operand and grid checks and
    the dtype-flow lint of every path.  A violation raises
    ``repro_torch.analysis.ScheduleError`` with the offending witness;
    ``"off"`` (default) skips the proof.  An unknown mode raises
    ``ValueError``.

    ``layout`` picks the preconditioner's coordinates: ``"round_major"``
    (state vectors in execution order, one fused 2S-step sweep per apply,
    no permutation in the loop) or ``"index"`` (state in HBMC order, two
    S-step sweeps per apply, each permuting into and out of round-major
    order).  ``spmv_format`` is ``"sell"`` (the SELL-w kernel)
    or ``"ell"`` (row-major ELL in PyTorch ops).  The port's default is
    ``"sell"``, where the reference's is ``"ell"``: a deliberate
    difference, since the SELL-w product is the one with a kernel.
    """
    return SolverPlan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      layout=layout, mesh=mesh, mesh_axis=mesh_axis,
                      lane_multiple=lane_multiple, on_breakdown=on_breakdown,
                      validate=validate, scheduler=scheduler, device=device)
