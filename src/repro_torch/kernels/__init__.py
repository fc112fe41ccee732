"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

hbmc_trisolve -- the fused forward+backward HBMC sweep, the IC(0) apply,
single-RHS and batched (``csrc/hbmc_trisolve.cu``; replaces the Pallas
``hbmc_trisolve_fused`` and ``hbmc_trisolve_fused_batched``), and the
single sweep of the index layout, single-RHS and batched (replaces the
Pallas ``hbmc_trisolve`` and ``hbmc_trisolve_batched``).

sell_spmv -- the SELL-w SpMV, single-RHS and batched (``csrc/sell_spmv.cu``;
replaces the Pallas ``sell_spmv`` and ``sell_spmv_batched``), and
``sell_spmv_block``, a rank's slice shard of a mesh through the same two
kernels.

The shard step -- one fused step of one rank's lane block of a fused table
sharded over a mesh (``hbmc_trisolve_shard_step``, ``_batched``; in
``csrc/hbmc_trisolve.cu``): the kernel of the mesh apply
``core.trisolve.DistributedRoundMajorPreconditioner``.

Each wrapper runs its CUDA kernel for a CUDA tensor and its plain version
(``ref.py``) for a CPU tensor.  The wrappers count into ``spans``'
counters, which the views here read: calls that launched
(``launch_counts``), the CUDA launches they issued
(``cuda_launch_counts``; one per barrier-free segment of the trisolve
kernels, ``segments.barrier_segments``), B1 / B5's launches by path
(``forwarding_counts``) and every call's operand bytes, on either device
(``operand_bytes``; ``_trace.kernel_node``, which also makes each call one
opaque node to ``repro_torch.analysis``'s dispatch linters).
``segments.analysed()`` lists the tables whose segments were computed.

``ops`` (imported on its own, since it reads ``repro_torch.core.sell``)
carries the index layout's tables and its kernel preconditioner.
"""
from ..spans import counts, reset_counts
from . import segments
from .config import DEFAULT_DEVICE, resolve_device
from .hbmc_trisolve import (hbmc_trisolve, hbmc_trisolve_batched,
                            hbmc_trisolve_fused, hbmc_trisolve_fused_batched,
                            hbmc_trisolve_shard_step,
                            hbmc_trisolve_shard_step_batched)
from .ref import (hbmc_trisolve_batched_ref, hbmc_trisolve_fused_batched_ref,
                  hbmc_trisolve_fused_ref, hbmc_trisolve_ref,
                  hbmc_trisolve_shard_step_ref, sell_spmv_batched_ref,
                  sell_spmv_ref, take_fill0)
from .sell_spmv import sell_spmv, sell_spmv_batched, sell_spmv_block

#: the counted wrappers, and B1 / B5's paths (``segments.single_paths``)
_WRAPPERS = ("hbmc_trisolve_fused", "sell_spmv", "hbmc_trisolve_fused_batched",
             "sell_spmv_batched", "hbmc_trisolve", "hbmc_trisolve_batched",
             "hbmc_trisolve_shard_step", "hbmc_trisolve_shard_step_batched",
             "sell_spmv_block")
_PATHS = ("on_chip", "plain", "grouped")


def _per_wrapper(kind: str) -> dict[str, int]:
    got = counts(f"kernels.{kind}.")
    return {name: got.get(name, 0) for name in _WRAPPERS}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return _per_wrapper("calls")


def cuda_launch_counts() -> dict[str, int]:
    """CUDA launches per wrapper since the last reset, as the C entry points
    report them: one per segment of the trisolve kernels (B1, B3, B5,
    B6), one per call of B2 / B4 and of the shard steps.
    ``sell_spmv_block``'s launches are B2's or B4's, counted under both
    names."""
    return _per_wrapper("cuda")


def operand_bytes() -> dict[str, int]:
    """Operand bytes per wrapper since the last reset: each tensor argument
    and the result once per outermost call, on the card and on the CPU
    (``_trace``); ``sell_spmv_block``'s calls count under its name only."""
    return _per_wrapper("bytes")


def forwarding_counts() -> dict[str, dict[str, int]]:
    """CUDA launches of B1 (``hbmc_trisolve_fused``) and B5
    (``hbmc_trisolve``) since the last reset, split by the path
    ``segments.single_paths`` gave each: ``on_chip``, ``plain`` and
    ``grouped`` (the lane-group path); the three add up to the wrapper's
    ``cuda_launch_counts()``."""
    got = counts("kernels.path.")
    return {name: {path: got.get(f"{name}.{path}", 0) for path in _PATHS}
            for name in ("hbmc_trisolve_fused", "hbmc_trisolve")}


def reset_launch_counts() -> None:
    """Zero the wrapper-call, CUDA-launch, path and operand-byte
    counters, and clear ``segments.analysed()``."""
    reset_counts("kernels.")
    segments.reset_analysed()
