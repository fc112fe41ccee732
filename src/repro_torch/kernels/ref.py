"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro.kernels.ref.hbmc_trisolve_fused_ref`` and
``sell_spmv_ref``, with the same op order: an elementwise multiply, then a
sum over K.  The wrappers in ``hbmc_trisolve.py`` / ``sell_spmv.py`` run
these for CPU tensors; on the card they are what each CUDA kernel is held
against.
"""
from __future__ import annotations

import torch


def take_fill0(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(v, idx, axis=0, fill_value=0)`` for a 1-D ``v``.

    An index in ``[-len, 0)`` wraps, as in JAX; an index outside
    ``[-len, len)`` reads 0.  The round-major packing uses the position
    ``S*R`` (one past the end) as the "no lane" hole.
    """
    n = v.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    inb = (idx >= 0) & (idx < n)
    got = v[torch.where(inb, idx, torch.zeros_like(idx))]
    return torch.where(inb, got, torch.zeros_like(got))


def hbmc_trisolve_fused_ref(cols: torch.Tensor, vals: torch.Tensor,
                            dinv: torch.Tensor, q: torch.Tensor
                            ) -> torch.Tensor:
    """z = (L L^T)^{-1} q in round-major coordinates.  cols: (2S, R, K).

    q: (S, R) -> z: (S*R,).  One buffer: the forward half fills it slice by
    slice, the backward half overwrites it in reverse slice order; step
    ``g >= S`` reads the slice it is about to overwrite as its right-hand
    side.
    """
    s2, r_, _ = cols.shape
    s_ = s2 // 2
    y = torch.zeros(s_ * r_, dtype=vals.dtype, device=vals.device)
    for g in range(s2):
        acc = torch.sum(vals[g] * take_fill0(y, cols[g]), dim=-1)    # (R,)
        dest = (g if g < s_ else s2 - 1 - g) * r_
        q_cur = q[g] if g < s_ else y[dest:dest + r_]
        y[dest:dest + r_] = (q_cur - acc) * dinv[g]
    return y


def sell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """y = A x with A as SELL-w slices (n_slices, K, w) -> (n_slices*w,)."""
    return torch.sum(vals * take_fill0(x, cols), dim=1).reshape(-1)
