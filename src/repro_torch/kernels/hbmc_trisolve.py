"""Fused HBMC triangular sweep: the IC(0) apply z = (L L^T)^{-1} q.

Port of ``repro.kernels.hbmc_trisolve.hbmc_trisolve_fused`` (the Pallas
kernel ``_fused_kernel``).  For a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/hbmc_trisolve.cu`` (one launch per fused step,
the kernel boundary being the round barrier; see the source for its design
and bound).  For a CPU tensor it runs the plain PyTorch version
``ref.hbmc_trisolve_fused_ref``.

``launches`` counts the wrapper calls that launched the CUDA kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import hbmc_trisolve_fused_ref

launches = 0

_ENTRY = {torch.float64: "hbmc_trisolve_fused_f64",
          torch.float32: "hbmc_trisolve_fused_f32"}


def _check(cols, vals, dinv, q) -> None:
    dev = q.device
    for name, t in (("cols", cols), ("vals", vals), ("dinv", dinv)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype not in _ENTRY:
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
    s2, r_, k_ = cols.shape
    s_ = s2 // 2
    if q.shape != (s_, r_):
        raise ValueError(f"q shape {tuple(q.shape)} != rounds shape "
                         f"{(s_, r_)}")
    if q.device.type == "cpu":
        return hbmc_trisolve_fused_ref(cols, vals, dinv, q)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(cols, vals, dinv, q)
    y = torch.zeros(s_ * r_, dtype=vals.dtype, device=q.device)
    if y.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.call(_ENTRY[vals.dtype], cols.data_ptr(), vals.data_ptr(),
                    dinv.data_ptr(), q.data_ptr(), y.data_ptr(), s_, r_, k_,
                    stream)
        launches += 1
    return y
