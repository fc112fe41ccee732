"""Distribution of the HBMC ICCG solver over a device mesh: one-shot wrappers.

Port of the solve wrappers of ``repro.core.partition``.  The distribution
layer proper lives in the plan stack:

    core/plan.py        ``build_plan(a, ..., mesh=, mesh_axis=)``: a
                        mesh-aware ``SolverPlan`` (factor once, solve many,
                        refactor in place), whose preconditioner apply is
                        the fused round-major sweep with one all-gather per
                        step
    core/trisolve.py    ``DistributedRoundMajorPreconditioner`` /
                        ``_dist_substitute_fused``: the sharded fused
                        fwd+bwd substitution (the shard step kernel on each
                        rank's lane block)
    core/iccg.py        ``make_sharded_spmv``: row/slice-sharded ELL/SELL
                        SpMV with one all-gather per product

Parallel-ordering semantics map onto the mesh as the paper maps them onto
threads (§4.4.3), one level up: colors are sequential rounds, the level-1
blocks of a color are spread over the ranks (the fused tables' lane axis is
sharded), and the w lanes of a block are the threads of a device.

Every rank calls these with the same arguments (SPMD).

``shard_tables`` and ``lower_solver_step`` are the index layout's mesh step
(the reference's legacy two-pass path): the lane axis of the index-layout
``DeviceTables`` sharded over one axis, and one PCG iteration with both
triangular sweeps over them -- captured once as a CUDA graph on the card,
where the reference lowers it to HLO for its roofline dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from ..kernels.ref import _sum_over_k
from .device_loop import BlockLoop
from .iccg import make_sharded_spmv, pcg_iteration
from .mesh import all_gather_, axis_group
from .plan import BatchedICCGReport, ICCGReport, build_plan
from .trisolve import DeviceTables


def distributed_iccg(a: sp.spmatrix, b: np.ndarray, mesh, *,
                     axis: str = "data", method: str = "hbmc",
                     block_size: int = 32, w: int = 8, shift: float = 0.0,
                     rtol: float = 1e-7, maxiter: int = 10_000,
                     spmv_format: str = "sell",
                     dtype: torch.dtype = torch.float64,
                     record_history: bool = False) -> ICCGReport:
    """One-shot distributed solve: mesh-aware plan, solve, report.

    Takes the original system (``a``, ``b``): ordering, padding and the
    round-major embedding happen inside the plan, and ``report.x`` carries
    the solution in the caller's ordering.  Workloads solving against one
    matrix repeatedly should hold the plan: ``build_plan(a, ...,
    mesh=mesh)`` then ``plan.solve(...)`` / ``plan.refactor(...)``.
    """
    plan = build_plan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      mesh=mesh, mesh_axis=axis)
    rep = plan.solve(np.asarray(b), rtol=rtol, maxiter=maxiter,
                     record_history=record_history)
    rep.setup_seconds += plan.timings.total
    return rep


def distributed_iccg_batched(a: sp.spmatrix, b: np.ndarray, mesh, *,
                             axis: str = "data", method: str = "hbmc",
                             block_size: int = 32, w: int = 8,
                             shift: float = 0.0, rtol: float = 1e-7,
                             maxiter: int = 10_000,
                             spmv_format: str = "sell",
                             dtype: torch.dtype = torch.float64,
                             record_history: bool = False
                             ) -> BatchedICCGReport:
    """Multi-RHS variant of ``distributed_iccg`` (``b``: (n, B))."""
    plan = build_plan(a, method=method, block_size=block_size, w=w,
                      shift=shift, spmv_format=spmv_format, dtype=dtype,
                      mesh=mesh, mesh_axis=axis)
    rep = plan.solve_batched(np.asarray(b), rtol=rtol, maxiter=maxiter,
                             record_history=record_history)
    rep.setup_seconds += plan.timings.total
    return rep


# ---------------------------------------------------------------------------
# The index layout's mesh step (the reference's legacy two-pass path).
# ---------------------------------------------------------------------------

def _pad_lanes(tables: DeviceTables, multiple: int) -> DeviceTables:
    """``tables`` with the lane axis R padded to a multiple of
    ``multiple``: the pad lanes' ``rows`` and ``cols`` point at the scratch
    slot ``n_slots - 1`` and their ``vals`` and ``dinv`` are 0, so they
    write +0 there and change nothing else."""
    extra = (-tables.dinv.shape[1]) % multiple
    if not extra:
        return tables
    scratch = tables.n_slots - 1

    def pad(t: torch.Tensor, fill) -> torch.Tensor:
        shape = (t.shape[0], extra) + tuple(t.shape[2:])
        return torch.cat([t, t.new_full(shape, fill)], dim=1)

    return DeviceTables(rows=pad(tables.rows, scratch),
                        cols=pad(tables.cols, scratch),
                        vals=pad(tables.vals, 0), dinv=pad(tables.dinv, 0),
                        n_slots=tables.n_slots)


def _lane_block(tables: DeviceTables, size: int, rank: int) -> DeviceTables:
    """Lane block ``rank`` of ``size`` of the padded tables (contiguous)."""
    padded = _pad_lanes(tables, size)
    r_loc = padded.dinv.shape[1] // size
    lanes = slice(rank * r_loc, (rank + 1) * r_loc)
    return DeviceTables(
        *(getattr(padded, name)[:, lanes].contiguous()
          for name in ("rows", "cols", "vals", "dinv")),
        n_slots=tables.n_slots)


def shard_tables(tables: DeviceTables, mesh,
                 axis: str = "data") -> DeviceTables:
    """This rank's lane block of index-layout step tables sharded over
    ``axis``: the port's counterpart of the reference's
    ``NamedSharding(P(None, axis))`` placement.  R is padded to a multiple
    of the axis size first (pad lanes follow the scratch-slot convention
    and are inert); rank i keeps lanes ``[i * r_loc, (i + 1) * r_loc)``."""
    _, size, rank = axis_group(mesh, axis)
    return _lane_block(tables, size, rank)


def _dist_substitute(block: DeviceTables, rows: torch.Tensor, group,
                     q: torch.Tensor) -> torch.Tensor:
    """``trisolve._substitute`` with the lane axis sharded: per step this
    rank computes its lanes' values from its replica of y, one all-gather
    assembles the step's R-wide row, and the row is scattered through the
    step's whole ``rows`` (replicated, as the state is).  The per-lane
    arithmetic is ``_substitute``'s, so the result is bitwise the
    unsharded sweep.  Every rank must call it (the collectives)."""
    extra = tuple(q.shape[1:])
    ones = (1,) * len(extra)
    pad = q.new_zeros((1,) + extra)
    y = torch.cat([q.new_zeros(q.shape), pad])
    qp = torch.cat([q, pad])
    for s in range(block.rows.shape[0]):
        acc = _sum_over_k(
            block.vals[s].reshape(block.vals.shape[1:] + ones)
            * y[block.cols[s]], dim=1)                     # (r_loc[, B])
        lanes = (qp[block.rows[s]] - acc) * block.dinv[s].reshape(
            block.dinv.shape[1:] + ones)
        row = lanes.new_empty((rows.shape[1],) + extra)
        all_gather_(row, lanes, group, "trisolve")
        y[rows[s]] = row
    return y[:-1]


@dataclasses.dataclass
class SolverStep:
    """One PCG iteration on a mesh, from ``lower_solver_step``.

    ``tables`` are this rank's lane blocks of the forward and backward
    step tables; ``eager`` is the iteration ``(x, r, p, rz) -> (x, r, p,
    rz)`` (``iccg.pcg_iteration`` over the sharded ELL SpMV and both
    sharded sweeps); ``step`` runs it, on the card as one captured CUDA
    graph: the first call eagerly (NCCL makes its communicator), then a
    capture, then replays.  ``sweep_steps`` counts the sweep steps of one
    apply (forward S plus backward S), ``gathers_per_iteration`` the
    all-gathers of one iteration (one a sweep step, one for the SpMV);
    ``graph`` is the captured graph (None on the CPU, or before the first
    call).
    """
    tables: tuple[DeviceTables, DeviceTables]
    eager: Callable
    sweep_steps: int
    gathers_per_iteration: int
    _loop: BlockLoop = dataclasses.field(
        default_factory=lambda: BlockLoop(1), repr=False)

    @property
    def graph(self) -> torch.cuda.CUDAGraph | None:
        return self._loop.graph

    def step(self, x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
             rz: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self._loop.run_once((x, r, p, rz),
                                   lambda state: self.eager(*state))


def lower_solver_step(fwd: DeviceTables, bwd: DeviceTables,
                      a_ell_cols: torch.Tensor, a_ell_vals: torch.Tensor,
                      mesh, axis: str = "data") -> SolverStep:
    """One PCG iteration on the mesh, both triangular sweeps present.

    The reference lowers ``iccg.pcg_iteration`` (the preconditioned
    pairings, carrying ``rz``) with the tables sharded over ``axis`` and
    the state replicated; the port builds the same iteration over this
    rank's lane blocks (``shard_tables``) and its row block of the (n, K)
    ELL operand (``make_sharded_spmv``), and captures it as one CUDA graph
    on the card (``SolverStep``).  The tables are the whole (replicated)
    index-layout tables of the HBMC-ordered system, with n = ``n_slots -
    1`` unknowns; like the reference it needs n and each table's R to be
    multiples of the axis size, and raises ``ValueError`` when they are
    not.  Every rank must call it and the step (SPMD).
    """
    group, size, rank = axis_group(mesh, axis)
    n = fwd.n_slots - 1
    if bwd.n_slots != fwd.n_slots or a_ell_cols.shape[0] != n \
            or a_ell_vals.shape != a_ell_cols.shape:
        raise ValueError(
            f"tables of {fwd.n_slots} / {bwd.n_slots} slots and an ELL "
            f"operand {tuple(a_ell_cols.shape)} / "
            f"{tuple(a_ell_vals.shape)} do not describe one system of "
            f"{n} unknowns")
    if n % size:
        raise ValueError(f"n = {n} is not a multiple of mesh axis {axis!r} "
                         f"({size}); arrange it through the HBMC block / w "
                         f"parameters")
    for name, t in (("fwd", fwd), ("bwd", bwd)):
        if t.dinv.shape[1] % size:
            raise ValueError(f"{name} tables have R = {t.dinv.shape[1]} "
                             f"lanes, not a multiple of mesh axis {axis!r} "
                             f"({size})")
    blocks = (shard_tables(fwd, mesh, axis), shard_tables(bwd, mesh, axis))
    rows = slice(rank * (n // size), (rank + 1) * (n // size))
    spmv = make_sharded_spmv("ell", n, mesh, axis,
                             a_ell_vals[rows].contiguous(),
                             a_ell_cols[rows].contiguous(), batched=False)

    def precond(v: torch.Tensor) -> torch.Tensor:
        y = _dist_substitute(blocks[0], fwd.rows, group, v)
        return _dist_substitute(blocks[1], bwd.rows, group, y)

    sweep_steps = fwd.rows.shape[0] + bwd.rows.shape[0]
    return SolverStep(tables=blocks, eager=pcg_iteration(spmv, precond),
                      sweep_steps=sweep_steps,
                      gathers_per_iteration=sweep_steps + 1)
