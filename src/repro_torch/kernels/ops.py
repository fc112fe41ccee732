"""The index layout's kernel preconditioner: host ``StepTables`` -> sweeps.

Port of ``repro.kernels.ops``.  ``DeviceRoundMajorTables.from_steps``
converts one sweep's ``StepTables`` once at setup (``sell.to_round_major``)
and moves it to a device; ``apply`` gathers an HBMC-ordered vector into
round-major order, runs the sweep through ``hbmc_trisolve`` (one RHS) or
``hbmc_trisolve_batched`` (B RHS), and scatters the result back to HBMC
order.  The tables carry their barrier-free segments
(``segments.barrier_segments``): both sweeps launch once per segment.
The tensor's device picks the CUDA kernel or its plain version, so the
reference's ``use_kernel`` / ``interpret`` switches have no counterpart.

Both permutations are scatters (``index_copy_``) with distinct indices,
precomputed on the host.  The reference gathers with ``rows`` and
scatters every pad lane into one dump slot; repeated indices in one
scatter are written in no fixed order on the card, and a row gather of an
(n, B) tensor runs far slower there than a scatter of it (chip_smoke.py
phase 4 times both).  So each direction scatters into a zeroed buffer of
n_live + n_pad + n_unlaned rows: lane positions first and HBMC rows
without a lane (dummies) after them one way, HBMC rows first and pad lanes
after them the other way, and the buffer's leading rows are the result.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import sell
from ..core.sell import StepTables
from .config import DEFAULT_DEVICE, resolve_device
from .hbmc_trisolve import hbmc_trisolve, hbmc_trisolve_batched
from .segments import table_segments


@dataclasses.dataclass
class DeviceRoundMajorTables:
    """``sell.RoundMajorTables`` of one sweep as tensors on one device."""
    cols: torch.Tensor   # (S, R, K) int32, round-major gather positions
    vals: torch.Tensor   # (S, R, K)
    dinv: torch.Tensor   # (S, R)
    pos: torch.Tensor    # (n,) int64 -- lane of each HBMC row; S*R + j for
                         #   the j-th row without a lane
    rows: torch.Tensor   # (S*R,) int64 -- HBMC row of each lane; n + j for
                         #   the j-th pad lane
    n_slots: int         # n + 1, as in StepTables
    n_buf: int           # n_live + n_pad + n_unlaned: rows of either buffer

    @functools.cached_property
    def segments(self) -> np.ndarray:
        """(n_segments,) int32 on the host, the barrier-free segments of
        ``cols`` (one B5 / B6 launch each): computed at first use (the
        first apply) and kept; ``SolverPlan.refactor`` carries them over
        while ``cols`` is unchanged."""
        return table_segments(self.cols, fused=False)

    @classmethod
    def from_host(cls, h: sell.RoundMajorTables,
                  dtype: torch.dtype = torch.float64,
                  device: str | torch.device = DEFAULT_DEVICE
                  ) -> "DeviceRoundMajorTables":
        device = resolve_device(device)
        n, rows = h.n_slots - 1, np.asarray(h.rows, dtype=np.int64).ravel()
        m = rows.size
        pad = rows == n
        pos = np.full(n, -1, dtype=np.int64)
        pos[rows[~pad]] = np.flatnonzero(~pad)
        unlaned = pos < 0
        pos[unlaned] = m + np.arange(int(unlaned.sum()))
        rows = rows.copy()
        rows[pad] = n + np.arange(int(pad.sum()))

        def put(a, dt=None):
            t = torch.tensor(np.asarray(a), device=device)
            return t if dt is None else t.to(dt)

        return cls(cols=put(np.asarray(h.cols, dtype=np.int32)),
                   vals=put(h.vals, dtype), dinv=put(h.dinv, dtype),
                   pos=put(pos), rows=put(rows), n_slots=h.n_slots,
                   n_buf=m + int(unlaned.sum()))

    @classmethod
    def from_steps(cls, t: StepTables, dtype: torch.dtype = torch.float64,
                   device: str | torch.device = DEFAULT_DEVICE
                   ) -> "DeviceRoundMajorTables":
        return cls.from_host(sell.to_round_major(t), dtype=dtype,
                             device=device)

    def _scatter(self, v: torch.Tensor, index: torch.Tensor,
                 keep: int) -> torch.Tensor:
        """Rows of ``v`` to rows ``index`` of a zeroed buffer; its first
        ``keep`` rows (contiguous)."""
        buf = v.new_zeros((self.n_buf,) + tuple(v.shape[1:]))
        return buf.index_copy_(0, index, v)[:keep]

    def to_round_major(self, q: torch.Tensor) -> torch.Tensor:
        """HBMC (n[, B]) -> round-major (S, R[, B]); pad lanes hold 0."""
        return self._scatter(q, self.pos, self.rows.numel()).reshape(
            tuple(self.dinv.shape) + tuple(q.shape[1:]))

    def from_round_major(self, y: torch.Tensor) -> torch.Tensor:
        """Round-major (S*R[, B]) -> HBMC (n[, B]); rows without a lane 0."""
        return self._scatter(y, self.rows, self.n_slots - 1)

    def apply(self, q: torch.Tensor) -> torch.Tensor:
        """One triangular solve.  q, result: (n_slots-1,) in HBMC order."""
        return self.from_round_major(hbmc_trisolve(
            self.cols, self.vals, self.dinv, self.to_round_major(q),
            segments=self.segments))

    def apply_batched(self, q: torch.Tensor) -> torch.Tensor:
        """Multi-RHS triangular solve.  q, result: (n_slots-1, B)."""
        return self.from_round_major(hbmc_trisolve_batched(
            self.cols, self.vals, self.dinv, self.to_round_major(q),
            segments=self.segments))


@dataclasses.dataclass(frozen=True)
class KernelPreconditioner:
    """IC(0) apply (L L^T)^{-1}: one forward and one backward sweep."""
    fwd: DeviceRoundMajorTables
    bwd: DeviceRoundMajorTables

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.bwd.apply(self.fwd.apply(r))

    def apply_batched(self, r: torch.Tensor) -> torch.Tensor:
        """Multi-RHS apply: r (n, B) -> (n, B)."""
        return self.bwd.apply_batched(self.fwd.apply_batched(r))


def build_kernel_preconditioner(fwd: StepTables, bwd: StepTables,
                                dtype: torch.dtype = torch.float64,
                                device: str | torch.device = DEFAULT_DEVICE
                                ) -> KernelPreconditioner:
    return KernelPreconditioner(
        fwd=DeviceRoundMajorTables.from_steps(fwd, dtype=dtype,
                                              device=device),
        bwd=DeviceRoundMajorTables.from_steps(bwd, dtype=dtype,
                                              device=device))
