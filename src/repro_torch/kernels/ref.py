"""Plain PyTorch versions of the port's kernels.

Counterparts of the six functions of ``repro.kernels.ref``
(``hbmc_trisolve_ref``, ``hbmc_trisolve_batched_ref``,
``hbmc_trisolve_fused_ref``, ``hbmc_trisolve_fused_batched_ref``,
``sell_spmv_ref`` and ``sell_spmv_batched_ref``), and of the per-device
step of the reference's ``core.trisolve._dist_substitute_fused``
(``hbmc_trisolve_shard_step_ref``), with the same op order:
an elementwise multiply, then a sum over K.  The sum runs over k in order,
one rounded add at a time, as the CUDA kernels do, so column j of a batched
version is bitwise equal to the single version on column j (``torch.sum``'s
reduction order depends on the layout, and would break that).  The wrappers in
``hbmc_trisolve.py`` / ``sell_spmv.py`` run these for CPU tensors; on the
card they are what each CUDA kernel is held against.
"""
from __future__ import annotations

import torch


def take_fill0(v: torch.Tensor, idx: torch.Tensor,
               lim: int | None = None) -> torch.Tensor:
    """``jnp.take(v, idx, axis=0, fill_value=0)``.

    Gathers whole rows of ``v`` (``v`` may be 1-D or carry trailing
    dimensions, such as the B columns of a slab).  An index in
    ``[-len, 0)`` wraps, as in JAX; an index outside ``[-len, len)`` reads
    0.  The round-major packing uses the position ``S*R`` (one past the
    end) as the "no lane" hole.  With ``lim`` a (wrapped) index at or after
    ``lim`` reads 0 too, as the trisolve kernels mask a forward step's reads
    of slices not yet written.
    """
    n = v.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    inb = (idx >= 0) & (idx < (n if lim is None else lim))
    got = v[torch.where(inb, idx, torch.zeros_like(idx))]
    inb = inb.reshape(inb.shape + (1,) * (v.dim() - 1))
    return torch.where(inb, got, torch.zeros_like(got))


def _sum_over_k(prod: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum ``prod`` over ``dim`` as ``((0 + p_0) + p_1) + ...``."""
    acc = torch.zeros_like(prod.select(dim, 0))
    for k in range(prod.shape[dim]):
        acc = acc + prod.select(dim, k)
    return acc


def _sweep_step(y: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                dinv: torch.Tensor, q_cur: torch.Tensor,
                lim: int | None = None) -> torch.Tensor:
    """One round: ``(q_cur - sum_k vals * y[cols]) * dinv`` for its R lanes
    (and B columns when ``y`` is (m, B)); ``lim`` as for ``take_fill0``."""
    extra = (1,) * (y.dim() - 1)
    acc = _sum_over_k(vals.reshape(vals.shape + extra)
                      * take_fill0(y, cols, lim), dim=1)       # (R[, B])
    return (q_cur - acc) * dinv.reshape(dinv.shape + extra)


def hbmc_trisolve_ref(cols: torch.Tensor, vals: torch.Tensor,
                      dinv: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """One round-major triangular sweep.  cols: (S, R, K).

    q: (S, R) -> y: (S*R,); or, for B right-hand sides at once, q: (S, R, B)
    -> y: (S*R, B).  Step s gathers from earlier slices only and stores
    slice s; ``S*R`` in ``cols`` marks a hole and reads 0.
    """
    s_, r_, _ = cols.shape
    y = torch.zeros((s_ * r_,) + tuple(q.shape[2:]), dtype=vals.dtype,
                    device=vals.device)
    for s in range(s_):
        y[s * r_:(s + 1) * r_] = _sweep_step(y, cols[s], vals[s], dinv[s],
                                             q[s])
    return y


def hbmc_trisolve_batched_ref(cols: torch.Tensor, vals: torch.Tensor,
                              dinv: torch.Tensor, q: torch.Tensor
                              ) -> torch.Tensor:
    """Multi-RHS sweep.  cols: (S, R, K); q: (S, R, B) -> (S*R, B)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (S, R, B), got {tuple(q.shape)}")
    return hbmc_trisolve_ref(cols, vals, dinv, q)


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
        dest = (g if g < s_ else s2 - 1 - g) * r_
        q_cur = q[g] if g < s_ else y[dest:dest + r_]
        y[dest:dest + r_] = _sweep_step(y, cols[g], vals[g], dinv[g], q_cur)
    return y


def hbmc_trisolve_fused_batched_ref(cols: torch.Tensor, vals: torch.Tensor,
                                    dinv: torch.Tensor, q: torch.Tensor
                                    ) -> torch.Tensor:
    """Multi-RHS fused apply.  cols: (2S, R, K); q: (S, R, B) -> (S*R, B)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (S, R, B), got {tuple(q.shape)}")
    return hbmc_trisolve_fused_ref(cols, vals, dinv, q)


def hbmc_trisolve_shard_step_ref(cols: torch.Tensor, vals: torch.Tensor,
                                 dinv: torch.Tensor, q: torch.Tensor,
                                 y: torch.Tensor, g: int,
                                 lane0: int) -> torch.Tensor:
    """Fused step ``g`` of one lane block of a fused table, in place.

    ``cols``/``vals`` (2S, r_loc, K) and ``dinv`` (2S, r_loc) are the lanes
    ``[lane0, lane0 + r_loc)`` of a fused table of ``r_full`` lanes; ``q``
    (S, r_full[, B]) and ``y`` (S*r_full[, B]) are the whole right-hand
    side and state.  Writes the block's entries of slice ``dest(g)`` of
    ``y`` (``hbmc_trisolve_fused_ref``'s step, restricted to the block) and
    returns ``y``.  A forward step reads the slices at or after ``g`` as 0,
    whatever ``y`` holds there, as the kernel does.
    """
    s2, r_loc, _ = cols.shape
    s_, r_full = s2 // 2, q.shape[1]
    fwd = g < s_
    dest = (g if fwd else s2 - 1 - g) * r_full + lane0
    q_cur = q[g, lane0:lane0 + r_loc] if fwd else y[dest:dest + r_loc]
    y[dest:dest + r_loc] = _sweep_step(y, cols[g], vals[g], dinv[g], q_cur,
                                       g * r_full if fwd else None)
    return y


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
