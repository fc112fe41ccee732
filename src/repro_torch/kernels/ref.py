"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro.kernels.ref.hbmc_trisolve_fused_ref``,
``hbmc_trisolve_fused_batched_ref``, ``sell_spmv_ref`` and
``sell_spmv_batched_ref``, with the same op order: an elementwise multiply,
then a sum over K.  The sum runs over k in order, one rounded add at a
time, as the CUDA kernels do, so column j of a batched version is bitwise
equal to the single version on column j (``torch.sum``'s reduction order
depends on the layout, and would break that).  The wrappers in
``hbmc_trisolve.py`` / ``sell_spmv.py`` run these for CPU tensors; on the
card they are what each CUDA kernel is held against.
"""
from __future__ import annotations

import torch


def take_fill0(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(v, idx, axis=0, fill_value=0)``.

    Gathers whole rows of ``v`` (``v`` may be 1-D or carry trailing
    dimensions, such as the B columns of a slab).  An index in
    ``[-len, 0)`` wraps, as in JAX; an index outside ``[-len, len)`` reads
    0.  The round-major packing uses the position ``S*R`` (one past the
    end) as the "no lane" hole.
    """
    n = v.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    inb = (idx >= 0) & (idx < n)
    got = v[torch.where(inb, idx, torch.zeros_like(idx))]
    inb = inb.reshape(inb.shape + (1,) * (v.dim() - 1))
    return torch.where(inb, got, torch.zeros_like(got))


def _sum_over_k(prod: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum ``prod`` over ``dim`` as ``((0 + p_0) + p_1) + ...``."""
    acc = torch.zeros_like(prod.select(dim, 0))
    for k in range(prod.shape[dim]):
        acc = acc + prod.select(dim, k)
    return acc


def hbmc_trisolve_fused_ref(cols: torch.Tensor, vals: torch.Tensor,
                            dinv: torch.Tensor, q: torch.Tensor
                            ) -> torch.Tensor:
    """z = (L L^T)^{-1} q in round-major coordinates.  cols: (2S, R, K).

    q: (S, R) -> z: (S*R,); or, for B right-hand sides at once, q: (S, R, B)
    -> z: (S*R, B).  One buffer: the forward half fills it slice by slice,
    the backward half overwrites it in reverse slice order; step ``g >= S``
    reads the slice it is about to overwrite as its right-hand side.
    """
    s2, r_, _ = cols.shape
    s_ = s2 // 2
    cols_b = q.shape[2:]                   # () or (B,)
    y = torch.zeros((s_ * r_,) + cols_b, dtype=vals.dtype,
                    device=vals.device)
    for g in range(s2):
        v = vals[g].reshape(vals.shape[1:] + (1,) * len(cols_b))
        acc = _sum_over_k(v * take_fill0(y, cols[g]), dim=1)   # (R[, B])
        d = dinv[g].reshape(dinv.shape[1:] + (1,) * len(cols_b))
        dest = (g if g < s_ else s2 - 1 - g) * r_
        q_cur = q[g] if g < s_ else y[dest:dest + r_]
        y[dest:dest + r_] = (q_cur - acc) * d
    return y


def hbmc_trisolve_fused_batched_ref(cols: torch.Tensor, vals: torch.Tensor,
                                    dinv: torch.Tensor, q: torch.Tensor
                                    ) -> torch.Tensor:
    """Multi-RHS fused apply.  cols: (2S, R, K); q: (S, R, B) -> (S*R, B)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (S, R, B), got {tuple(q.shape)}")
    return hbmc_trisolve_fused_ref(cols, vals, dinv, q)


def sell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """y = A x with A as SELL-w slices (n_slices, K, w) -> (n_slices*w,);
    or Y = A X for X (n, B) -> (n_slices*w, B)."""
    v = vals.reshape(vals.shape + (1,) * (x.dim() - 1))
    y = _sum_over_k(v * take_fill0(x, cols), dim=1)    # (n_slices, w[, B])
    return y.reshape((-1,) + tuple(x.shape[1:]))


def sell_spmv_batched_ref(vals: torch.Tensor, cols: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Multi-RHS SELL-w SpMV.  x: (n, B) -> (n_slices*w, B)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, B), got {tuple(x.shape)}")
    return sell_spmv_ref(vals, cols, x)
