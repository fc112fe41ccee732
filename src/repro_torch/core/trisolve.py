"""Vectorized forward/backward substitution over HBMC step tables (§4.3).

Port of ``repro.core.trisolve`` for one device, in two layouts
(``build_plan(layout=...)``):

* ``"round_major"`` (the default): the factor is packed into the fused
  round-major tables (``sell.fuse_round_major``): step ``g`` of ``2S``
  gathers from previous rounds, forms ``t = (q - sum_k vals * y[cols]) *
  dinv`` for the R lanes of its round and stores them as one contiguous
  slice.  The apply's input and output are round-major vectors, so a PCG
  loop on them does no permutation at all.  ``RoundMajorPreconditioner``
  runs ``kernels.hbmc_trisolve_fused`` (one RHS) or
  ``kernels.hbmc_trisolve_fused_batched`` (B RHS held as (m, B) columns).
* ``"index"``: the apply works on vectors in HBMC (permuted-matrix) order.
  ``HBMCPreconditioner`` holds a ``kernels.ops.KernelPreconditioner``,
  which permutes each sweep's input into round-major order, runs
  ``kernels.hbmc_trisolve`` / ``hbmc_trisolve_batched`` and permutes the
  result back: two sweeps and four permutations per apply.

Every kernel wrapper launches its CUDA kernel for tensors on the card and
runs its plain PyTorch version for tensors on the CPU.

``DeviceTables`` and ``_substitute`` are the reference's index-space
substitution (its ``backend="xla"``), written as PyTorch ops on whatever
device holds the tables: a scatter by ``rows`` per round, with an optional
starting iterate ``x0``.  They carry the GS/SOR smoothers
(``core.smoothers``) and the tests; the plan's preconditioner never runs
them.

Under a ``DeviceMesh`` (``build_plan(mesh=...)``) the fused tables' lane
axis is sharded over one mesh axis: ``shard_fused_tables`` keeps this
rank's lane block, and ``DistributedRoundMajorPreconditioner`` runs the
fused sweep with one all-gather per step (``_dist_substitute_fused``, the
reference's "one collective per round"); the state vectors are replicated.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from ..kernels.config import DEFAULT_DEVICE, resolve_device
from ..kernels.hbmc_trisolve import (hbmc_trisolve_fused,
                                     hbmc_trisolve_fused_batched,
                                     hbmc_trisolve_shard_step,
                                     hbmc_trisolve_shard_step_batched)
from ..kernels.ref import _sum_over_k
from ..kernels.segments import table_segments
from .hbmc import HBMCOrdering
from .mesh import all_gather_, axis_group
from .sell import (FusedRoundMajorTables, RoundMajorLayout, StepTables,
                   fuse_round_major, pack_factor, pack_factor_hbmc,
                   rounds_hbmc)

LAYOUTS = ("round_major", "index")


@dataclasses.dataclass
class DeviceTables:
    """``sell.StepTables`` as tensors on one device."""
    rows: torch.Tensor   # (S, R) int64 -- HBMC row of each lane (pad -> n)
    cols: torch.Tensor   # (S, R, K) int64 -- HBMC columns (pad -> n)
    vals: torch.Tensor   # (S, R, K)
    dinv: torch.Tensor   # (S, R)
    n_slots: int

    @classmethod
    def from_host(cls, t: StepTables, dtype: torch.dtype = torch.float64,
                  device: str | torch.device = DEFAULT_DEVICE
                  ) -> "DeviceTables":
        device = resolve_device(device)
        return cls(rows=torch.tensor(t.rows, dtype=torch.int64,
                                     device=device),
                   cols=torch.tensor(t.cols, dtype=torch.int64,
                                     device=device),
                   vals=torch.tensor(t.vals, device=device).to(dtype),
                   dinv=torch.tensor(t.dinv, device=device).to(dtype),
                   n_slots=t.n_slots)


def _substitute(tables: DeviceTables, q: torch.Tensor,
                x0: torch.Tensor | None = None) -> torch.Tensor:
    """Run all rounds of one triangular solve.  q: (n_slots-1[, B]).

    With ``x0`` the vector starts from an existing iterate and the rounds
    overwrite it in place: a Gauss-Seidel sweep when the tables hold the
    full off-diagonal part of A (``core.smoothers``).  The sum over K runs
    in k order, so column j of a (n, B) solve is bitwise the solve of
    column j.  Pad lanes gather only the dump slot ``n_slots-1`` with
    ``vals = dinv = 0`` and so all write +0 there: the repeated indices of
    the per-round scatter carry one value.
    """
    extra = tuple(q.shape[1:])
    pad = q.new_zeros((1,) + extra)
    y = torch.cat([q.new_zeros(q.shape) if x0 is None else x0, pad])
    qp = torch.cat([q, pad])
    ones = (1,) * len(extra)
    for s in range(tables.rows.shape[0]):
        rows = tables.rows[s]                                  # (R,)
        acc = _sum_over_k(
            tables.vals[s].reshape(tables.vals.shape[1:] + ones)
            * y[tables.cols[s]], dim=1)                        # (R[, B])
        y[rows] = (qp[rows] - acc) * tables.dinv[s].reshape(
            tables.dinv.shape[1:] + ones)
    return y[:-1]


def _substitute_batched(tables: DeviceTables,
                        q: torch.Tensor) -> torch.Tensor:
    """Multi-RHS ``_substitute``.  q: (n_slots-1, B)."""
    if q.dim() != 2:
        raise ValueError(f"q must be (n, B), got {tuple(q.shape)}")
    return _substitute(tables, q)


def forward_solve(tables: DeviceTables, q: torch.Tensor) -> torch.Tensor:
    """y = L^{-1} q over the packed forward tables (eq. 4.12-4.18)."""
    return _substitute(tables, q)


def backward_solve(tables: DeviceTables, y: torch.Tensor) -> torch.Tensor:
    """z = L^{-T} y over the packed backward tables."""
    return _substitute(tables, y)


def forward_solve_batched(tables: DeviceTables,
                          q: torch.Tensor) -> torch.Tensor:
    """Y = L^{-1} Q over the packed forward tables.  Q: (n, B)."""
    return _substitute_batched(tables, q)


def backward_solve_batched(tables: DeviceTables,
                           y: torch.Tensor) -> torch.Tensor:
    """Z = L^{-T} Y over the packed backward tables.  Y: (n, B)."""
    return _substitute_batched(tables, y)


@dataclasses.dataclass
class DeviceFusedTables:
    """``sell.FusedRoundMajorTables`` as tensors on one device.

    Row ``g`` of each tensor drives fused step ``g``: forward rounds for
    ``g < S``, backward rounds (backward execution order) for ``g >= S``.
    ``segments`` are the start steps of the table's barrier-free segments,
    for the trisolve kernels, which launch once per segment.
    """
    cols: torch.Tensor   # (2S, R, K) int32 -- fwd-round-major gather positions
    vals: torch.Tensor   # (2S, R, K)
    dinv: torch.Tensor   # (2S, R)

    @functools.cached_property
    def segments(self) -> np.ndarray:
        """(n_segments,) int32 on the host, ``barrier_segments`` of
        ``cols``: computed at first use (the first apply) and kept, so a
        plan that never solves never pays for it (about 0.2 s at the 1M
        plan's tables, ``chip_smoke.py`` phase 3); ``SolverPlan.refactor``
        carries them over while ``cols`` is unchanged."""
        return table_segments(self.cols, fused=True)

    @property
    def n_steps(self) -> int:
        """Rounds per sweep (the fused loop runs 2 * n_steps steps)."""
        return self.dinv.shape[0] // 2

    @property
    def lanes(self) -> int:
        return self.dinv.shape[1]

    @classmethod
    def from_arrays(cls, cols: np.ndarray, vals: np.ndarray,
                    dinv: np.ndarray, dtype: torch.dtype,
                    device: torch.device) -> "DeviceFusedTables":
        return cls(cols=torch.tensor(np.asarray(cols, dtype=np.int32),
                                     device=device),
                   vals=torch.tensor(np.asarray(vals), device=device).to(dtype),
                   dinv=torch.tensor(np.asarray(dinv), device=device).to(dtype))

    @classmethod
    def from_host(cls, f: FusedRoundMajorTables, dtype: torch.dtype,
                  device: torch.device) -> "DeviceFusedTables":
        return cls.from_arrays(f.cols, f.vals, f.dinv, dtype, device)


def fused_solve(tables: DeviceFusedTables, q: torch.Tensor) -> torch.Tensor:
    """z = (L L^T)^{-1} q, round-major in and out.  q: (S, R) -> (S*R,)."""
    return hbmc_trisolve_fused(tables.cols, tables.vals, tables.dinv, q,
                               segments=tables.segments)


def fused_solve_batched(tables: DeviceFusedTables,
                        q: torch.Tensor) -> torch.Tensor:
    """Multi-RHS fused apply.  q: (S, R, B) -> (S*R, B)."""
    return hbmc_trisolve_fused_batched(tables.cols, tables.vals, tables.dinv,
                                       q, segments=tables.segments)


@dataclasses.dataclass(frozen=True)
class RoundMajorPreconditioner:
    """IC(0) apply on round-major (m,) state vectors.

    The only permutations of a solve happen in
    ``RoundMajorLayout.embed``/``extract``, once each, outside the PCG loop.
    """
    tables: DeviceFusedTables

    @property
    def n_rounds(self) -> int:
        return self.tables.n_steps

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return fused_solve(self.tables,
                           r.reshape(self.tables.n_steps, self.tables.lanes))

    def apply_batched(self, r: torch.Tensor) -> torch.Tensor:
        """The apply on B columns at once: r (m, B) -> z (m, B)."""
        return fused_solve_batched(
            self.tables,
            r.reshape(self.tables.n_steps, self.tables.lanes, r.shape[-1]))


# ---------------------------------------------------------------------------
# Mesh-sharded fused substitution: the lane axis R is sharded over one mesh
# axis, the solution vector is replicated, and each fused step ends in ONE
# all-gather of the step's lane updates -- the distributed analogue of the
# paper's "one synchronization per color" (§4.4.3), one level up: level-1
# blocks -> devices, w lanes -> the threads of a device.
# ---------------------------------------------------------------------------

def _dist_substitute_fused(mesh, axis: str, m: int, cols: torch.Tensor,
                           vals: torch.Tensor, dinv: torch.Tensor,
                           q: torch.Tensor, batched: bool) -> torch.Tensor:
    """Fused fwd+bwd sweep with the lane axis sharded over ``axis``.

    ``cols``/``vals`` (2S, r_loc, K) and ``dinv`` (2S, r_loc) are this
    rank's lane block of tables of ``r_full = r_loc * size`` lanes; ``q``
    is the whole right-hand side, (S, r_full) (or (S, r_full, B)), the
    same on every rank.  Per fused step every rank computes its own lane
    block's updates from its replica of y (the shard step kernel) and one
    all-gather, in place, assembles the step's slice before the next step:
    the per-lane arithmetic is ``fused_solve``'s, so the result is bitwise
    the single-device sweep over the same tables.  Returns y (m[, B]), the
    same on every rank.  Every rank must call it (the collectives).
    """
    group, size, rank = axis_group(mesh, axis)
    s2, r_loc, _ = cols.shape
    s_, r_full = s2 // 2, r_loc * size
    if q.shape[:2] != (s_, r_full) or m != s_ * r_full \
            or q.dim() != (3 if batched else 2):
        raise ValueError(f"q {tuple(q.shape)} does not fit {size} lane "
                         f"blocks of tables {tuple(cols.shape)} (m = {m})")
    step = hbmc_trisolve_shard_step_batched if batched else \
        hbmc_trisolve_shard_step
    lane0 = rank * r_loc
    # every slice is written (by a forward step) before any step reads it
    # unmasked, so y needs no zeros
    y = torch.empty((m,) + tuple(q.shape[2:]), dtype=q.dtype,
                    device=q.device)
    for g in range(s2):
        step(cols, vals, dinv, q, y, g, lane0)
        dest = (g if g < s_ else s2 - 1 - g) * r_full
        slab = y[dest:dest + r_full]
        all_gather_(slab, slab[lane0:lane0 + r_loc], group, "trisolve")
    return y


@dataclasses.dataclass(frozen=True)
class DistributedRoundMajorPreconditioner:
    """``RoundMajorPreconditioner`` sharded over a device mesh axis.

    ``tables`` hold this rank's lane block of the fused round-major tables
    (``shard_fused_tables``): the heavy data is fully distributed, the (m,)
    state vectors stay replicated.  The apply is the fused 2S-step sweep
    with one all-gather per step (``_dist_substitute_fused``).
    """
    tables: DeviceFusedTables
    mesh: Any
    axis: str = "data"

    @property
    def n_rounds(self) -> int:
        return self.tables.n_steps

    @property
    def lanes(self) -> int:
        """Lanes of the whole (unsharded) tables."""
        return self.tables.lanes * axis_group(self.mesh, self.axis)[1]

    @property
    def m(self) -> int:
        return self.tables.n_steps * self.lanes

    def _apply(self, r: torch.Tensor, batched: bool) -> torch.Tensor:
        t = self.tables
        shape = (t.n_steps, self.lanes) + tuple(r.shape[1:])
        return _dist_substitute_fused(self.mesh, self.axis, self.m, t.cols,
                                      t.vals, t.dinv, r.reshape(shape),
                                      batched)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self._apply(r, batched=False)

    def apply_batched(self, r: torch.Tensor) -> torch.Tensor:
        """The apply on B columns at once: r (m, B) -> z (m, B)."""
        return self._apply(r, batched=True)


def shard_fused_tables(tables: DeviceFusedTables, mesh,
                       axis: str = "data") -> DeviceFusedTables:
    """This rank's lane block of fused tables sharded over ``axis``.

    The lane axis must already be a multiple of the axis size -- build the
    plan/tables with ``lane_multiple = size`` (``pack_factor(...,
    lane_multiple=...)``) rather than re-padding here, so every round-major
    position stays valid.  Returns new contiguous tensors on the tables'
    device.
    """
    _, size, rank = axis_group(mesh, axis)
    if tables.lanes % size != 0:
        raise ValueError(
            f"lane axis ({tables.lanes}) is not a multiple of mesh axis "
            f"{axis!r} ({size}); pack with lane_multiple={size}")
    r_loc = tables.lanes // size
    lanes = slice(rank * r_loc, (rank + 1) * r_loc)
    return DeviceFusedTables(cols=tables.cols[:, lanes].contiguous(),
                             vals=tables.vals[:, lanes].contiguous(),
                             dinv=tables.dinv[:, lanes].contiguous())


def build_round_major_preconditioner_from_rounds(
        l_final: sp.csr_matrix, fwd_rounds, bwd_rounds, drop_mask=None,
        dtype: torch.dtype = torch.float64,
        device: str | torch.device = DEFAULT_DEVICE, lane_multiple: int = 1
        ) -> tuple[RoundMajorPreconditioner, RoundMajorLayout]:
    """Pack a factor into the fused round-major form; returns the
    preconditioner plus the layout (the b-in / x-out permutation pair).

    ``lane_multiple`` pads the lane axis so it shards evenly over a mesh
    axis of that size (see ``DistributedRoundMajorPreconditioner``)."""
    device = resolve_device(device)
    fwd_h, bwd_h = pack_factor(l_final, fwd_rounds, bwd_rounds, drop_mask,
                               lane_multiple)
    fused_h = fuse_round_major(fwd_h, bwd_h)
    pre = RoundMajorPreconditioner(
        tables=DeviceFusedTables.from_host(fused_h, dtype=dtype,
                                           device=device))
    return pre, fused_h.layout


def build_round_major_preconditioner(
        l_final: sp.csr_matrix, ordering: HBMCOrdering,
        dtype: torch.dtype = torch.float64,
        device: str | torch.device = DEFAULT_DEVICE
        ) -> tuple[RoundMajorPreconditioner, RoundMajorLayout]:
    """``build_round_major_preconditioner_from_rounds`` over an HBMC
    ordering's rounds, its dummy rows dropped."""
    return build_round_major_preconditioner_from_rounds(
        l_final, rounds_hbmc(ordering, reverse=False),
        rounds_hbmc(ordering, reverse=True), drop_mask=ordering.is_dummy,
        dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class HBMCPreconditioner:
    """IC(0) apply  M^{-1} r = (L L^T)^{-1} r  on vectors in HBMC order.

    ``kernel`` is a ``kernels.ops.KernelPreconditioner``: both sweeps run
    through the single-sweep kernels (B5 for one RHS, B6 for (n, B)), the
    CUDA kernels on the card and their plain versions on the CPU.
    """
    kernel: Any
    n_final: int

    @property
    def n_rounds(self) -> int:
        return int(self.kernel.fwd.dinv.shape[0])

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.kernel(r)

    def apply_batched(self, r: torch.Tensor) -> torch.Tensor:
        """Multi-RHS apply: r (n, B) -> (n, B), columns independent."""
        return self.kernel.apply_batched(r)


def _assemble_preconditioner(fwd_h: StepTables, bwd_h: StepTables,
                             n_final: int, dtype: torch.dtype,
                             device: str | torch.device
                             ) -> HBMCPreconditioner:
    # deferred: kernels.ops imports core.sell, and so this package
    from ..kernels.ops import build_kernel_preconditioner
    return HBMCPreconditioner(
        kernel=build_kernel_preconditioner(fwd_h, bwd_h, dtype=dtype,
                                           device=device),
        n_final=n_final)


def build_preconditioner(l_final: sp.csr_matrix, ordering: HBMCOrdering,
                         dtype: torch.dtype = torch.float64,
                         device: str | torch.device = DEFAULT_DEVICE
                         ) -> HBMCPreconditioner:
    fwd_h, bwd_h = pack_factor_hbmc(l_final, ordering)
    return _assemble_preconditioner(fwd_h, bwd_h, ordering.n_final, dtype,
                                    device)


def build_preconditioner_from_rounds(
        l_final: sp.csr_matrix, fwd_rounds, bwd_rounds, drop_mask=None,
        dtype: torch.dtype = torch.float64,
        device: str | torch.device = DEFAULT_DEVICE) -> HBMCPreconditioner:
    """Generic variant: MC / BMC / natural solvers share the machinery."""
    fwd_h, bwd_h = pack_factor(l_final, fwd_rounds, bwd_rounds, drop_mask)
    return _assemble_preconditioner(fwd_h, bwd_h, l_final.shape[0], dtype,
                                    device)


# ---------------------------------------------------------------------------
# Sequential oracle (host), used by tests to pin down exact semantics.
# ---------------------------------------------------------------------------

def sequential_forward(l: sp.csr_matrix, q: np.ndarray) -> np.ndarray:
    return spsolve_triangular(sp.csr_matrix(l), q, lower=True)


def sequential_backward(l: sp.csr_matrix, y: np.ndarray) -> np.ndarray:
    return spsolve_triangular(sp.csr_matrix(l).T.tocsr(), y, lower=False)
