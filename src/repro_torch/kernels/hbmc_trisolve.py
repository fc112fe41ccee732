"""Fused HBMC triangular sweep: the IC(0) apply z = (L L^T)^{-1} q.

Port of ``repro.kernels.hbmc_trisolve.hbmc_trisolve_fused`` (the Pallas
kernel ``_fused_kernel``) and of its multi-RHS form
``hbmc_trisolve_fused_batched`` (``_fused_batched_kernel``).  For a CUDA
tensor each wrapper launches its hand-written kernel in
``csrc/hbmc_trisolve.cu`` (one launch per fused step, the kernel boundary
being the round barrier; see the source for the design and bound).  For a
CPU tensor it runs the plain PyTorch version in ``ref``.

``launches`` / ``batched_launches`` count the wrapper calls that launched
the single-RHS / batched CUDA kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .config import runs_plain
from .ref import hbmc_trisolve_fused_batched_ref, hbmc_trisolve_fused_ref

launches = 0
batched_launches = 0

_FLOATS = (torch.float64, torch.float32)
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _check(cols, vals, dinv, q) -> None:
    dev = q.device
    for name, t in (("cols", cols), ("vals", vals), ("dinv", dinv)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype not in _FLOATS:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if dinv.dtype != vals.dtype or q.dtype != vals.dtype:
        raise TypeError(f"dtypes differ: vals {vals.dtype}, dinv "
                        f"{dinv.dtype}, q {q.dtype}")
    if vals.shape != cols.shape or dinv.shape != cols.shape[:2]:
        raise ValueError(f"table shapes disagree: cols {tuple(cols.shape)}, "
                         f"vals {tuple(vals.shape)}, dinv "
                         f"{tuple(dinv.shape)}")
    for name, t in (("cols", cols), ("vals", vals), ("dinv", dinv), ("q", q)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _run(entry: str, cols, vals, dinv, q) -> torch.Tensor:
    """Check the operands and launch the 2S steps of ``entry`` into a
    zeroed (S*R[, B]) buffer; returns it."""
    _check(cols, vals, dinv, q)
    s_, r_, k_ = q.shape[0], q.shape[1], cols.shape[2]
    y = torch.zeros((s_ * r_,) + tuple(q.shape[2:]), dtype=vals.dtype,
                    device=q.device)
    if y.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.call(f"{entry}_{_SUFFIX[vals.dtype]}", cols.data_ptr(),
                    vals.data_ptr(), dinv.data_ptr(), q.data_ptr(),
                    y.data_ptr(), s_, r_, k_, *q.shape[2:], stream)
    return y


def hbmc_trisolve_fused(cols: torch.Tensor, vals: torch.Tensor,
                        dinv: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """z = (L L^T)^{-1} q in round-major coordinates.

    Args:
      cols: (2S, R, K) int32 -- forward round-major gather positions; rows
        0..S-1 drive the forward rounds, S..2S-1 the backward rounds in
        backward execution order (``sell.fuse_round_major``); ``S*R`` marks
        a hole and reads 0.  Step g never reads the slice it writes (lanes of
        one round are independent); every packed table satisfies this, and
        the CUDA kernel relies on it.
      vals: (2S, R, K) -- off-diagonal values (0 on padding).
      dinv: (2S, R) -- inverse diagonal (0 on padding lanes).
      q:    (S, R) -- right-hand side in round-major layout.

    Returns:
      z: (S*R,) solution in round-major layout (holes stay 0).
    """
    global launches
    s2, r_, _ = cols.shape
    if q.shape != (s2 // 2, r_):
        raise ValueError(f"q shape {tuple(q.shape)} != rounds shape "
                         f"{(s2 // 2, r_)}")
    if runs_plain(q):
        return hbmc_trisolve_fused_ref(cols, vals, dinv, q)
    y = _run("hbmc_trisolve_fused", cols, vals, dinv, q)
    launches += 1
    return y


def hbmc_trisolve_fused_batched(cols: torch.Tensor, vals: torch.Tensor,
                                dinv: torch.Tensor,
                                q: torch.Tensor) -> torch.Tensor:
    """Multi-RHS fused apply.  q: (S, R, B) -> z: (S*R, B).

    The B right-hand sides share every load of cols/vals/dinv; column j of
    the result is bitwise equal to ``hbmc_trisolve_fused`` on ``q[..., j]``
    (on the card and on the CPU alike).  Any B >= 1.
    """
    global batched_launches
    s2, r_, _ = cols.shape
    if q.dim() != 3 or q.shape[:2] != (s2 // 2, r_):
        raise ValueError(f"q shape {tuple(q.shape)} != {(s2 // 2, r_)} + "
                         "(B,)")
    if runs_plain(q):
        return hbmc_trisolve_fused_batched_ref(cols, vals, dinv, q)
    y = _run("hbmc_trisolve_fused_batched", cols, vals, dinv, q)
    batched_launches += 1
    return y
