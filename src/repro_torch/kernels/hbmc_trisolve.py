"""HBMC triangular sweeps in round-major coordinates.

Ports of the four Pallas kernels of ``repro.kernels.hbmc_trisolve``:

* ``hbmc_trisolve_fused`` (``_fused_kernel``) and its multi-RHS form
  ``hbmc_trisolve_fused_batched`` (``_fused_batched_kernel``): the IC(0)
  apply z = (L L^T)^{-1} q, forward and backward sweeps fused into 2S steps;
* ``hbmc_trisolve`` (``_trisolve_kernel``) and ``hbmc_trisolve_batched``
  (``_trisolve_batched_kernel``): one sweep of S steps, the index layout's
  forward or backward solve.

For a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/hbmc_trisolve.cu`` (see the source for the design and bound) once
per barrier-free segment of its table (``segments.barrier_segments``), the
kernel boundary being the only barrier; ``segments=np.arange(G)`` gives one
launch per step, the reference's round barrier.  The single-RHS wrappers
pass each launch's path, which ``segments.single_paths`` picks from the
table's shape and the segment's length: the on-chip path, where a thread
serves the reads of what it wrote in the same launch from registers and
shared memory and loads everything else ahead (``segments.forwarded_reads``
marks the reads it serves); the lane-group path for a table of long rows
on few lanes, G threads of a warp a lane, the row's entries gathered and
multiplied side by side and summed in k order by the group's first thread;
or the plain path, which loads the next step's table entries ahead of the
current step's gathers.  The batched ones run the plain per-step loop.  For
a CPU tensor each wrapper runs the plain PyTorch version in ``ref``, whose
result is the step-major one, and ignores ``segments``.

Each wrapper counts, in ``spans``' counters, its calls that launched, the
CUDA launches they issued (one per segment, as the C entry points report
them) and, for B1 and B5, those launches by path; ``kernels`` reads them
(``launch_counts``, ``cuda_launch_counts``, ``forwarding_counts``).

``hbmc_trisolve_shard_step`` and ``hbmc_trisolve_shard_step_batched`` run
one fused step of one rank's lane block of a fused table sharded over a
mesh axis (the per-device body of the reference's
``core.trisolve._dist_substitute_fused``, which ``core.trisolve`` follows
with an all-gather of the step's slice): one launch per call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spans import count
from . import _build
from ._trace import kernel_node
from .config import runs_plain
from .ref import (hbmc_trisolve_batched_ref, hbmc_trisolve_fused_batched_ref,
                  hbmc_trisolve_fused_ref, hbmc_trisolve_ref,
                  hbmc_trisolve_shard_step_ref)
from .segments import ON_CHIP, PLAIN, single_paths, table_segments

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


def _run(entry: str, cols, vals, dinv, q, seg: np.ndarray,
         paths: np.ndarray | None = None) -> tuple[torch.Tensor, int]:
    """Launch ``entry`` once per segment of ``seg`` (checked operands) into
    a new (S*R[, B]) buffer, which the kernels need no zeros in, on the
    path of each segment's code in ``paths`` (the single-RHS kernels);
    returns it and the number of CUDA launches."""
    s_, r_, k_ = q.shape[0], q.shape[1], cols.shape[2]
    shape = (s_ * r_,) + tuple(q.shape[2:])
    y = torch.empty(shape, dtype=vals.dtype, device=q.device)
    if not y.numel():
        return y, 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    single = () if paths is None else (paths.ctypes.data,)
    n = _build.call(f"{entry}_{_SUFFIX[vals.dtype]}", cols.data_ptr(),
                    vals.data_ptr(), dinv.data_ptr(), q.data_ptr(),
                    y.data_ptr(), s_, r_, k_, *q.shape[2:], seg.ctypes.data,
                    int(seg.size), *single, stream)
    return y, n


def _launch(name: str, cols, vals, dinv, q, segments,
            fused: bool) -> torch.Tensor:
    """Check the operands and ``segments``, launch ``name``'s kernel once
    per segment (each B1 / B5 launch on its ``single_paths`` path) and
    count the call, its CUDA launches and their paths."""
    _check(cols, vals, dinv, q)
    seg = _segments(segments, cols, fused)
    paths = None
    if q.dim() == 2:
        paths = single_paths(cols.shape[2], q.shape[1], q.shape[0], seg,
                             fused)
    y, n = _run(name, cols, vals, dinv, q, seg, paths)
    count(f"kernels.calls.{name}")
    count(f"kernels.cuda.{name}", n)
    if paths is not None and n:
        count(f"kernels.path.{name}.plain", int((paths == PLAIN).sum()))
        count(f"kernels.path.{name}.on_chip", int((paths == ON_CHIP).sum()))
        count(f"kernels.path.{name}.grouped", int((paths > ON_CHIP).sum()))
    return y


def _segments(segments, cols: torch.Tensor, fused: bool) -> np.ndarray:
    """The segment starts to launch: ``segments`` checked, or computed from
    ``cols`` when None."""
    if segments is None:
        return table_segments(cols, fused)
    seg = np.ascontiguousarray(segments, dtype=np.int32)
    n_steps = cols.shape[0]
    if (seg.ndim != 1 or seg.size == 0 or seg[0] != 0
            or np.any(np.diff(seg) <= 0) or seg[-1] >= max(n_steps, 1)):
        raise ValueError(f"segments must be ascending step starts from 0 "
                         f"below {n_steps}, got {seg.tolist()}")
    return seg


@kernel_node("hbmc_trisolve_fused")
def hbmc_trisolve_fused(cols: torch.Tensor, vals: torch.Tensor,
                        dinv: torch.Tensor, q: torch.Tensor,
                        segments=None) -> torch.Tensor:
    """z = (L L^T)^{-1} q in round-major coordinates.

    Args:
      cols: (2S, R, K) int32 -- forward round-major gather positions; rows
        0..S-1 drive the forward rounds, S..2S-1 the backward rounds in
        backward execution order (``sell.fuse_round_major``); ``S*R`` marks
        a hole and reads 0.  Step g never reads another lane's entry of the
        slice it writes (lanes of one round are independent); every packed
        table satisfies this, and the CUDA kernel relies on it.
      vals: (2S, R, K) -- off-diagonal values (0 on padding).
      dinv: (2S, R) -- inverse diagonal (0 on padding lanes).
      q:    (S, R) -- right-hand side in round-major layout.
      segments: int32 start steps of the barrier-free segments of ``cols``
        (``segments.barrier_segments(cols, fused=True)``; the plan's tables
        carry them).  On the card each segment is one launch; any cut finer
        than the computed one (``np.arange(2S)``: one launch per step) gives
        the same bits.  None computes them from ``cols`` on the host: a
        device-to-host copy of ``cols`` and about 0.2 s at the 1M plan's
        tables, per call, so the solve paths always pass them.  The plain
        (CPU) version ignores ``segments``: its result is the step-major
        one.

    Returns:
      z: (S*R,) solution in round-major layout (holes stay 0).
    """
    s2, r_, _ = cols.shape
    if q.shape != (s2 // 2, r_):
        raise ValueError(f"q shape {tuple(q.shape)} != rounds shape "
                         f"{(s2 // 2, r_)}")
    if runs_plain(q):
        return hbmc_trisolve_fused_ref(cols, vals, dinv, q)
    return _launch("hbmc_trisolve_fused", cols, vals, dinv, q, segments,
                   True)


@kernel_node("hbmc_trisolve_fused_batched")
def hbmc_trisolve_fused_batched(cols: torch.Tensor, vals: torch.Tensor,
                                dinv: torch.Tensor, q: torch.Tensor,
                                segments=None) -> torch.Tensor:
    """Multi-RHS fused apply.  q: (S, R, B) -> z: (S*R, B).

    The B right-hand sides share every load of cols/vals/dinv; column j of
    the result is bitwise equal to ``hbmc_trisolve_fused`` on ``q[..., j]``
    (on the card and on the CPU alike).  Any B >= 1.  ``segments`` as for
    ``hbmc_trisolve_fused``.
    """
    s2, r_, _ = cols.shape
    if q.dim() != 3 or q.shape[:2] != (s2 // 2, r_):
        raise ValueError(f"q shape {tuple(q.shape)} != {(s2 // 2, r_)} + "
                         "(B,)")
    if runs_plain(q):
        return hbmc_trisolve_fused_batched_ref(cols, vals, dinv, q)
    return _launch("hbmc_trisolve_fused_batched", cols, vals, dinv, q,
                   segments, True)


@kernel_node("hbmc_trisolve")
def hbmc_trisolve(cols: torch.Tensor, vals: torch.Tensor, dinv: torch.Tensor,
                  q: torch.Tensor, segments=None) -> torch.Tensor:
    """One round-major triangular sweep (``sell.to_round_major`` tables).

    Args:
      cols: (S, R, K) int32 -- round-major gather positions; step s reads
        only slices 0..s-1 (every packed table satisfies this; a read of a
        later slice reads the zero the state starts from); ``S*R`` marks a
        hole and reads 0.
      vals: (S, R, K) -- off-diagonal values (0 on padding).
      dinv: (S, R) -- inverse diagonal (0 on padding lanes).
      q:    (S, R) -- right-hand side in round-major layout.
      segments: as for ``hbmc_trisolve_fused``, of the sweep table
        (``barrier_segments(cols, fused=False)``).

    Returns:
      y: (S*R,) solution in round-major layout.
    """
    if q.shape != cols.shape[:2]:
        raise ValueError(f"q shape {tuple(q.shape)} != rounds shape "
                         f"{tuple(cols.shape[:2])}")
    if runs_plain(q):
        return hbmc_trisolve_ref(cols, vals, dinv, q)
    return _launch("hbmc_trisolve", cols, vals, dinv, q, segments, False)


@kernel_node("hbmc_trisolve_batched")
def hbmc_trisolve_batched(cols: torch.Tensor, vals: torch.Tensor,
                          dinv: torch.Tensor, q: torch.Tensor,
                          segments=None) -> torch.Tensor:
    """Multi-RHS sweep.  q: (S, R, B) -> y: (S*R, B).

    The B right-hand sides share every load of cols/vals/dinv; column j of
    the result is bitwise equal to ``hbmc_trisolve`` on ``q[..., j]`` (on
    the card and on the CPU alike).  Any B >= 1.  ``segments`` as for
    ``hbmc_trisolve``.
    """
    if q.dim() != 3 or q.shape[:2] != cols.shape[:2]:
        raise ValueError(f"q shape {tuple(q.shape)} != "
                         f"{tuple(cols.shape[:2])} + (B,)")
    if runs_plain(q):
        return hbmc_trisolve_batched_ref(cols, vals, dinv, q)
    return _launch("hbmc_trisolve_batched", cols, vals, dinv, q, segments,
                   False)


@kernel_node("hbmc_trisolve_shard_step")
def hbmc_trisolve_shard_step(cols: torch.Tensor, vals: torch.Tensor,
                             dinv: torch.Tensor, q: torch.Tensor,
                             y: torch.Tensor, g: int,
                             lane0: int) -> torch.Tensor:
    """Fused step ``g`` of the lane block ``[lane0, lane0 + r_loc)``, in
    place.

    Args:
      cols, vals: (2S, r_loc, K) -- the block's lanes of a fused table of
        ``r_full`` lanes (``hbmc_trisolve_fused``'s tables, lane-sharded).
      dinv: (2S, r_loc).
      q: (S, r_full) -- the whole right-hand side, round-major.
      y: (S*r_full,) -- the whole state: slices before ``g`` (forward) or
        all of them (backward) hold the earlier steps' results; a forward
        step reads the slices at or after ``g`` as 0, whatever they hold.
      g: the step, 0 <= g < 2S.
      lane0: the block's first lane in the state.

    Writes the block's ``r_loc`` entries of slice ``dest(g)`` of ``y``
    (``g`` for a forward step, ``2S-1-g`` for a backward one) and returns
    ``y``.  The arithmetic is ``hbmc_trisolve_fused``'s: with ``r_loc ==
    r_full`` and ``lane0 == 0`` the 2S steps in order are bitwise one fused
    apply.
    """
    if q.dim() != 2:
        raise ValueError(f"q must be (S, R), got {tuple(q.shape)}")
    if runs_plain(q):
        _check_shard(cols, vals, dinv, q, y, g, lane0)
        return hbmc_trisolve_shard_step_ref(cols, vals, dinv, q, y, g, lane0)
    _run_shard("hbmc_trisolve_shard_step", cols, vals, dinv, q, y, g, lane0)
    return y


@kernel_node("hbmc_trisolve_shard_step_batched")
def hbmc_trisolve_shard_step_batched(cols: torch.Tensor, vals: torch.Tensor,
                                     dinv: torch.Tensor, q: torch.Tensor,
                                     y: torch.Tensor, g: int,
                                     lane0: int) -> torch.Tensor:
    """Multi-RHS shard step: q (S, r_full, B), y (S*r_full, B), row-major.
    Column j is bitwise ``hbmc_trisolve_shard_step`` on column j."""
    if q.dim() != 3:
        raise ValueError(f"q must be (S, R, B), got {tuple(q.shape)}")
    if runs_plain(q):
        _check_shard(cols, vals, dinv, q, y, g, lane0)
        return hbmc_trisolve_shard_step_ref(cols, vals, dinv, q, y, g, lane0)
    _run_shard("hbmc_trisolve_shard_step_batched", cols, vals, dinv, q, y, g,
               lane0)
    return y


def _check_shard(cols, vals, dinv, q, y, g: int, lane0: int) -> None:
    """``_check`` on the table shard and ``q``, then ``y``, ``g`` and the
    lane block against them."""
    s2, r_loc, _ = cols.shape
    if q.shape[0] * 2 != s2:
        raise ValueError(f"q has {q.shape[0]} rounds, the table {s2} steps")
    # the block's table shape is checked against its own lanes, q against
    # the state's
    _check(cols, vals, dinv, q)
    r_full = q.shape[1]
    if y.device != q.device or y.dtype != q.dtype or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous {q.dtype} tensor on "
                         f"{q.device}")
    if tuple(y.shape) != (q.shape[0] * r_full,) + tuple(q.shape[2:]):
        raise ValueError(f"y shape {tuple(y.shape)} does not hold q "
                         f"{tuple(q.shape)}")
    if not (0 <= g < s2 and 0 <= lane0 and lane0 + r_loc <= r_full):
        raise ValueError(f"step {g} of {s2}, lanes [{lane0}, "
                         f"{lane0 + r_loc}) of {r_full}")


def _run_shard(entry: str, cols, vals, dinv, q, y, g: int,
               lane0: int) -> None:
    """Check and launch a shard step, and count the call and its CUDA
    launch."""
    _check_shard(cols, vals, dinv, q, y, g, lane0)
    s2, r_loc, k_ = cols.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n = _build.call(f"{entry}_{_SUFFIX[vals.dtype]}", cols.data_ptr(),
                    vals.data_ptr(), dinv.data_ptr(), q.data_ptr(),
                    y.data_ptr(), int(g), s2 // 2, r_loc, k_, *q.shape[2:],
                    q.shape[1], int(lane0), stream)
    count(f"kernels.cuda.{entry}", n)
    count(f"kernels.calls.{entry}")
