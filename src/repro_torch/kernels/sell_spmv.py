"""SELL-w sparse matrix-vector product y = A x.

Port of ``repro.kernels.sell_spmv.sell_spmv`` (the Pallas kernel
``_sell_spmv_kernel``).  For a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/sell_spmv.cu`` (one thread per output row; see
the source for its design and bound).  For a CPU tensor it runs the plain
PyTorch version ``ref.sell_spmv_ref``.  The TPU kernel's slice-tile padding
was a VMEM artefact and is gone.

``launches`` counts the wrapper calls that launched the CUDA kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import sell_spmv_ref

launches = 0

_ENTRY = {torch.float64: "sell_spmv_f64", torch.float32: "sell_spmv_f32"}


def _check(vals, cols, x) -> None:
    if vals.device != x.device or cols.device != x.device:
        raise ValueError(f"operands on {vals.device}/{cols.device}, x on "
                         f"{x.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype not in _ENTRY or x.dtype != vals.dtype:
        raise TypeError(f"vals and x must share float32 or float64, got "
                        f"{vals.dtype} and {x.dtype}")
    if cols.shape != vals.shape or x.dim() != 1:
        raise ValueError(f"shapes: vals {tuple(vals.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    for name, t in (("vals", vals), ("cols", cols), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
    if x.device.type == "cpu":
        return sell_spmv_ref(vals, cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(vals, cols, x)
    n_slices, k_, w_ = vals.shape
    y = torch.empty(n_slices * w_, dtype=vals.dtype, device=x.device)
    if y.numel():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.call(_ENTRY[vals.dtype], vals.data_ptr(), cols.data_ptr(),
                    x.data_ptr(), y.data_ptr(), n_slices, k_, w_, x.shape[0],
                    stream)
        launches += 1
    return y
