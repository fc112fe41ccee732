"""Parallel Gauss-Seidel / SOR smoothers on the HBMC round machinery.

Port of ``repro.core.smoothers``.  The sweep x_i <- (1-w) x_i + w (b_i -
sum_{j != i} a_ij x_j) / a_ii has the dependence structure of the forward
substitution, so the same round tables apply: pack the full off-diagonal
part of A in the ordering's rounds and run the substitution in place,
starting from the current iterate (``trisolve._substitute(x0=)``).  The
equivalence of orderings for GS (the paper's eq. 3.4) then holds by the
same argument: a BMC sweep equals an HBMC sweep
(tests/test_torch_smoothers.py).

A sweep is PyTorch ops on the smoother's device (``"cuda"`` by default),
as the reference's is jnp ops outside any Pallas kernel.  It does not go
through the single-sweep kernel ``kernels.hbmc_trisolve``: that kernel
starts from zeros by contract, while a GS sweep starts from an existing
iterate and overwrites it.  This is the smoother's own path on the card,
not a fallback.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..kernels.config import DEFAULT_DEVICE
from .sell import pack_steps
from .trisolve import DeviceTables, _substitute


@dataclasses.dataclass(frozen=True)
class GSSmoother:
    fwd: DeviceTables       # full off-diagonal rows, forward round order
    bwd: DeviceTables       # same rows, reverse round order (symmetric GS)
    n: int
    omega: float = 1.0      # SOR relaxation

    @property
    def device(self) -> torch.device:
        return self.fwd.vals.device

    def sweep(self, b: torch.Tensor, x: torch.Tensor, *,
              reverse: bool = False) -> torch.Tensor:
        t = self.bwd if reverse else self.fwd
        x_new = _substitute(t, b, x0=x)
        if self.omega != 1.0:
            x_new = (1 - self.omega) * x + self.omega * x_new
        return x_new

    def symmetric_sweep(self, b: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
        return self.sweep(b, self.sweep(b, x), reverse=True)


def build_gs_smoother(a_bar: sp.spmatrix, fwd_rounds, bwd_rounds,
                      drop_mask=None, omega: float = 1.0,
                      dtype: torch.dtype = torch.float64,
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> GSSmoother:
    """a_bar: reordered (padded) matrix; rounds from ``sell.rounds_*``."""
    a_bar = sp.csr_matrix(a_bar)
    n = a_bar.shape[0]
    diag = a_bar.diagonal()
    off = sp.csr_matrix(a_bar - sp.diags(diag))
    off.eliminate_zeros()
    fwd = pack_steps(off, diag, fwd_rounds, drop_mask)
    bwd = pack_steps(off, diag, bwd_rounds, drop_mask)
    return GSSmoother(fwd=DeviceTables.from_host(fwd, dtype=dtype,
                                                 device=device),
                      bwd=DeviceTables.from_host(bwd, dtype=dtype,
                                                 device=device),
                      n=n, omega=omega)


def gs_solve(smoother: GSSmoother, b: np.ndarray, *, sweeps: int = 100,
             rtol: float = 1e-8, a_bar: sp.spmatrix | None = None
             ) -> tuple[np.ndarray, list[float]]:
    """Stationary GS/SOR iteration (host loop).

    Returns the last iterate and, when ``a_bar`` is given, the relative
    residual after each sweep, computed on the host as the reference does
    (one copy of x to the host per sweep); it stops early below ``rtol``.
    """
    b = np.asarray(b)
    bd = torch.as_tensor(b, device=smoother.device,
                         dtype=smoother.fwd.vals.dtype)
    x = torch.zeros_like(bd)
    hist = []
    for _ in range(sweeps):
        x = smoother.sweep(bd, x)
        if a_bar is not None:
            x_host = x.cpu().numpy()
            r = np.linalg.norm(b - a_bar @ x_host) / np.linalg.norm(b)
            hist.append(r)
            if r < rtol:
                break
    return x.cpu().numpy(), hist
