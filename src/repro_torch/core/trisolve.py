"""Round-major IC(0) apply: the fused forward/backward substitution (§4.3).

Port of the round-major half of ``repro.core.trisolve``.  The factor is
packed into the fused round-major tables (``sell.fuse_round_major``): step
``g`` of ``2S`` gathers from previous rounds, forms
``t = (q - sum_k vals * y[cols]) * dinv`` for the R lanes of its round and
stores them as one contiguous slice.  The apply's input and output are
round-major vectors, so a PCG loop on them does no permutation at all.

Every apply goes through ``kernels.hbmc_trisolve_fused`` (one RHS) or
``kernels.hbmc_trisolve_fused_batched`` (B RHS held as (m, B) columns): the
CUDA kernel for tensors on the card, its plain PyTorch version for tensors
on the CPU.  The index-space preconditioner and the mesh-sharded apply
belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..kernels.config import DEFAULT_DEVICE, resolve_device
from ..kernels.hbmc_trisolve import (hbmc_trisolve_fused,
                                     hbmc_trisolve_fused_batched)
from .sell import (FusedRoundMajorTables, RoundMajorLayout, fuse_round_major,
                   pack_factor)


@dataclasses.dataclass
class DeviceFusedTables:
    """``sell.FusedRoundMajorTables`` as tensors on one device.

    Row ``g`` of each tensor drives fused step ``g``: forward rounds for
    ``g < S``, backward rounds (backward execution order) for ``g >= S``.
    """
    cols: torch.Tensor   # (2S, R, K) int32 -- fwd-round-major gather positions
    vals: torch.Tensor   # (2S, R, K)
    dinv: torch.Tensor   # (2S, R)

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
    return hbmc_trisolve_fused(tables.cols, tables.vals, tables.dinv, q)


def fused_solve_batched(tables: DeviceFusedTables,
                        q: torch.Tensor) -> torch.Tensor:
    """Multi-RHS fused apply.  q: (S, R, B) -> (S*R, B)."""
    return hbmc_trisolve_fused_batched(tables.cols, tables.vals, tables.dinv,
                                       q)


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


def build_round_major_preconditioner_from_rounds(
        l_final: sp.csr_matrix, fwd_rounds, bwd_rounds, drop_mask=None,
        dtype: torch.dtype = torch.float64,
        device: str | torch.device = DEFAULT_DEVICE
        ) -> tuple[RoundMajorPreconditioner, RoundMajorLayout]:
    """Pack a factor into the fused round-major form; returns the
    preconditioner plus the layout (the b-in / x-out permutation pair)."""
    device = resolve_device(device)
    fwd_h, bwd_h = pack_factor(l_final, fwd_rounds, bwd_rounds, drop_mask)
    fused_h = fuse_round_major(fwd_h, bwd_h)
    pre = RoundMajorPreconditioner(
        tables=DeviceFusedTables.from_host(fused_h, dtype=dtype,
                                           device=device))
    return pre, fused_h.layout
