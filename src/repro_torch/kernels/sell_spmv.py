"""SELL-w sparse matrix-vector product y = A x, and Y = A X for B columns.

Port of ``repro.kernels.sell_spmv.sell_spmv`` (the Pallas kernel
``_sell_spmv_kernel``) and ``sell_spmv_batched``
(``_sell_spmv_batched_kernel``).  For a CUDA tensor each wrapper launches
its hand-written kernel in ``csrc/sell_spmv.cu`` (see the source for the
design and bound).  For a CPU tensor it runs the plain PyTorch version in
``ref``.  The TPU kernels' slice-tile padding was a VMEM artefact and is
gone.  ``batched_launch`` picks the batched kernel's variant and launch
shape; it is plain Python, so the CPU tests reach it.

``sell_spmv_block`` is the port of the reference's ``sell_spmv_block``,
the per-device SpMV of a mesh: a rank's slice shard against the replicated
x, through the same two kernels.

Each wrapper counts, in ``spans``' counters, its calls that launched and
the CUDA launches they issued (one per call, as the C entry points report
them); ``sell_spmv_block``'s calls count in the kernel's own counters too.
"""
from __future__ import annotations

import dataclasses

import torch

from ..spans import count, counts
from . import _build
from ._trace import kernel_node
from .config import runs_plain
from .ref import sell_spmv_batched_ref, sell_spmv_ref

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

MAX_UNROLL_K = 8        # csrc/sell_spmv.cu MAX_UNROLL_K
BATCHED_THREADS = 256   # threads a block of the batched kernel


@dataclasses.dataclass(frozen=True)
class BatchedLaunch:
    """One launch of the batched kernel: thread t of the launch's range
    (block b's chunk is ``(b % 2) * blocks / 2 + b // 2``, the two halves
    of the rows side by side) computes row ``t // (B / cols_per_thread)``,
    columns ``cols_per_thread`` from ``(t % (B / cols_per_thread)) *
    cols_per_thread``."""
    cols_per_thread: int   # 1: scalar; 16 bytes of columns: vector
    k_unrolled: int        # K, fully unrolled; 0: chunks of 8 (K > 8 or 0)
    blocks: int            # even
    threads: int

    @property
    def vector(self) -> bool:
        return self.cols_per_thread > 1


def batched_launch(n_slices: int, k: int, w: int, nb: int,
                   dtype: torch.dtype, x_align: int) -> BatchedLaunch:
    """Variant and shape of the batched kernel for Y = A X.

    ``x_align`` is ``x.data_ptr() % 16``.  The vector variant (one thread
    per row and 16 bytes of columns) needs B a multiple of 16 bytes of
    columns and X on a 16-byte boundary; every other shape runs the scalar
    variant (one column a thread).  K up to ``MAX_UNROLL_K`` is unrolled
    whole.  Raises ``ValueError`` for what neither variant takes.
    """
    if dtype not in _SUFFIX:
        raise TypeError(f"the batched kernel takes float32 or float64, got "
                        f"{dtype}")
    size = torch.empty((), dtype=dtype).element_size()
    if min(n_slices, k, w, nb) < 0 or not 0 <= x_align < 16 \
            or x_align % size:
        raise ValueError(f"no batched SpMV variant for n_slices={n_slices}, "
                         f"K={k}, w={w}, B={nb}, {dtype}, x at {x_align} "
                         f"mod 16")
    vec = 16 // size
    cpt = vec if nb % vec == 0 and x_align == 0 else 1
    n_threads = n_slices * w * (nb // cpt)
    blocks = -(-n_threads // BATCHED_THREADS)
    blocks += blocks % 2
    if blocks > 2**31 - 1:
        raise ValueError(f"{n_threads} threads exceed one launch's grid")
    return BatchedLaunch(cols_per_thread=cpt,
                         k_unrolled=k if k <= MAX_UNROLL_K else 0,
                         blocks=blocks, threads=BATCHED_THREADS)


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


def _run(entry: str, vals, cols, x, *shape) -> torch.Tensor:
    """Launch ``entry`` (with the launch ``shape`` arguments that follow B,
    if any), count the call and its CUDA launches, and return y."""
    n_slices, k_, w_ = vals.shape
    y = torch.empty((n_slices * w_,) + tuple(x.shape[1:]), dtype=vals.dtype,
                    device=x.device)
    n = 0
    if y.numel():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        n = _build.call(f"{entry}_{_SUFFIX[vals.dtype]}", vals.data_ptr(),
                        cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                        n_slices, k_, w_, x.shape[0], *x.shape[1:], *shape,
                        stream)
    count(f"kernels.calls.{entry}")
    count(f"kernels.cuda.{entry}", n)
    return y


@kernel_node("sell_spmv")
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
    if runs_plain(x):
        return sell_spmv_ref(vals, cols, x)
    _check(vals, cols, x, 1)
    return _run("sell_spmv", vals, cols, x)


@kernel_node("sell_spmv_batched")
def sell_spmv_batched(vals: torch.Tensor, cols: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Y = A X for B column vectors at once.  x: (n_pad, B).

    One load of the (K, w) index plane serves the columns of a thread
    (``batched_launch`` picks its variant); column j of the result is
    bitwise equal to ``sell_spmv`` on ``x[:, j]``.

    Returns:
      y: (n_slices * w, B) in slice-row-major order.
    """
    if runs_plain(x):
        return sell_spmv_batched_ref(vals, cols, x)
    _check(vals, cols, x, 2)
    n_slices, k_, w_ = vals.shape
    launch = batched_launch(n_slices, k_, w_, x.shape[1], x.dtype,
                            x.data_ptr() % 16)
    return _run("sell_spmv_batched", vals, cols, x, launch.cols_per_thread,
                launch.k_unrolled, launch.blocks, launch.threads)


@kernel_node("sell_spmv_block")
def sell_spmv_block(vals: torch.Tensor, cols: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Per-device block SpMV of a mesh (``core.iccg.make_sharded_spmv``).

    ``vals``/``cols`` are the device-local slice shard ((s_loc, K, w));
    ``x`` is the replicated input ((n_pad,) or (n_pad, B)) indexed by
    global positions, so the local gather needs no index translation.
    Returns the local row block ((s_loc * w,) or (s_loc * w, B)); the
    caller assembles the full result with one all-gather.  Runs
    ``sell_spmv`` (B2) for a 1-D ``x`` and ``sell_spmv_batched`` (B4) for a
    2-D one: their kernels on the card, their plain versions on the CPU.
    """
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be (n,) or (n, B), got {tuple(x.shape)}")
    before = _spmv_launches()
    y = sell_spmv(vals, cols, x) if x.dim() == 1 else \
        sell_spmv_batched(vals, cols, x)
    if not runs_plain(x):
        count("kernels.calls.sell_spmv_block")
        count("kernels.cuda.sell_spmv_block", _spmv_launches() - before)
    return y


def _spmv_launches() -> int:
    """The CUDA launches B2 and B4 have counted."""
    got = counts("kernels.cuda.")
    return got.get("sell_spmv", 0) + got.get("sell_spmv_batched", 0)
