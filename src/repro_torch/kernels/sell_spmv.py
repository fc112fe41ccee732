"""SELL-w sparse matrix-vector product y = A x, and Y = A X for B columns.

Port of ``repro.kernels.sell_spmv.sell_spmv`` (the Pallas kernel
``_sell_spmv_kernel``) and ``sell_spmv_batched``
(``_sell_spmv_batched_kernel``).  For a CUDA tensor each wrapper launches
its hand-written kernel in ``csrc/sell_spmv.cu`` (one thread per output
entry; see the source for the design and bound).  For a CPU tensor it runs
the plain PyTorch version in ``ref``.  The TPU kernels' slice-tile padding
was a VMEM artefact and is gone.

``launches`` / ``batched_launches`` count the wrapper calls that launched
the single-RHS / batched CUDA kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .config import runs_plain
from .ref import sell_spmv_batched_ref, sell_spmv_ref

launches = 0
batched_launches = 0

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _check(vals, cols, x, x_dim: int) -> None:
    if vals.device != x.device or cols.device != x.device:
        raise ValueError(f"operands on {vals.device}/{cols.device}, x on "
                         f"{x.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype not in _SUFFIX or x.dtype != vals.dtype:
        raise TypeError(f"vals and x must share float32 or float64, got "
                        f"{vals.dtype} and {x.dtype}")
    if cols.shape != vals.shape or vals.dim() != 3 or x.dim() != x_dim:
        raise ValueError(f"shapes: vals {tuple(vals.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    for name, t in (("vals", vals), ("cols", cols), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _run(entry: str, vals, cols, x) -> torch.Tensor:
    n_slices, k_, w_ = vals.shape
    y = torch.empty((n_slices * w_,) + tuple(x.shape[1:]), dtype=vals.dtype,
                    device=x.device)
    if y.numel():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.call(f"{entry}_{_SUFFIX[vals.dtype]}", vals.data_ptr(),
                    cols.data_ptr(), x.data_ptr(), y.data_ptr(), n_slices,
                    k_, w_, x.shape[0], *x.shape[1:], stream)
    return y


def sell_spmv(vals: torch.Tensor, cols: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """y = A x with A in SELL-w layout.

    Args:
      vals: (n_slices, K, w) slice-packed values (0 padding).
      cols: (n_slices, K, w) int32 column indices (padding -> any index
        whose vals entry is 0; an index past the end of x reads 0).
      x:    (n_pad,) input vector.

    Returns:
      y: (n_slices * w,) in slice-row-major order.
    """
    global launches
    if runs_plain(x):
        return sell_spmv_ref(vals, cols, x)
    _check(vals, cols, x, 1)
    y = _run("sell_spmv", vals, cols, x)
    launches += 1
    return y


def sell_spmv_batched(vals: torch.Tensor, cols: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Y = A X for B column vectors at once.  x: (n_pad, B).

    One load of the (K, w) index plane serves all B columns; column j of
    the result is bitwise equal to ``sell_spmv`` on ``x[:, j]``.

    Returns:
      y: (n_slices * w, B) in slice-row-major order.
    """
    global batched_launches
    if runs_plain(x):
        return sell_spmv_batched_ref(vals, cols, x)
    _check(vals, cols, x, 2)
    y = _run("sell_spmv_batched", vals, cols, x)
    batched_launches += 1
    return y
