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
(``ref.py``) for a CPU tensor, and counts its calls that launched
(``launch_counts``) and the CUDA launches those calls issued
(``cuda_launch_counts``).  The trisolve kernels launch once per
barrier-free segment of their table (``segments.barrier_segments``);
``forwarding_counts`` splits the single-RHS ones (B1, B5) by the path
each launch took, and ``segments.analysed()`` lists the tables whose
segments were computed.
Every wrapper call, on either device, also adds its operands' bytes
(``operand_bytes``) and is one opaque node to ``repro_torch.analysis``'s
dispatch linters (``_trace.kernel_node``).

``ops`` (imported on its own, since it reads ``repro_torch.core.sell``)
carries the index layout's tables and its kernel preconditioner.
"""
from . import _trace, segments
from . import hbmc_trisolve as _hbmc_trisolve_mod
from . import sell_spmv as _sell_spmv_mod
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

# wrapper name -> (module, counter attribute)
_COUNTED = {
    "hbmc_trisolve_fused": (_hbmc_trisolve_mod, "launches"),
    "sell_spmv": (_sell_spmv_mod, "launches"),
    "hbmc_trisolve_fused_batched": (_hbmc_trisolve_mod, "batched_launches"),
    "sell_spmv_batched": (_sell_spmv_mod, "batched_launches"),
    "hbmc_trisolve": (_hbmc_trisolve_mod, "sweep_launches"),
    "hbmc_trisolve_batched": (_hbmc_trisolve_mod, "sweep_batched_launches"),
    "hbmc_trisolve_shard_step": (_hbmc_trisolve_mod, "shard_launches"),
    "hbmc_trisolve_shard_step_batched": (_hbmc_trisolve_mod,
                                         "shard_batched_launches"),
    "sell_spmv_block": (_sell_spmv_mod, "block_launches"),
}

# wrapper name -> (module, counter of the CUDA launches its calls issued)
_CUDA_COUNTED = {
    "hbmc_trisolve_fused": (_hbmc_trisolve_mod, "cuda_launches"),
    "sell_spmv": (_sell_spmv_mod, "cuda_launches"),
    "hbmc_trisolve_fused_batched": (_hbmc_trisolve_mod,
                                    "batched_cuda_launches"),
    "sell_spmv_batched": (_sell_spmv_mod, "batched_cuda_launches"),
    "hbmc_trisolve": (_hbmc_trisolve_mod, "sweep_cuda_launches"),
    "hbmc_trisolve_batched": (_hbmc_trisolve_mod,
                              "sweep_batched_cuda_launches"),
    "hbmc_trisolve_shard_step": (_hbmc_trisolve_mod, "shard_cuda_launches"),
    "hbmc_trisolve_shard_step_batched": (_hbmc_trisolve_mod,
                                         "shard_batched_cuda_launches"),
    "sell_spmv_block": (_sell_spmv_mod, "block_cuda_launches"),
}

# wrapper name -> (module, counter of the operand bytes of its calls)
_BYTES_COUNTED = {name: (_trace, f"{name}_bytes") for name in _COUNTED}

# single-RHS trisolve wrapper -> path -> (module, counter of its CUDA
# launches on that path)
_PATH_COUNTED = {
    "hbmc_trisolve_fused": {"on_chip": (_hbmc_trisolve_mod,
                                        "on_chip_launches"),
                            "plain": (_hbmc_trisolve_mod, "plain_launches"),
                            "wide": (_hbmc_trisolve_mod, "wide_launches"),
                            "grouped": (_hbmc_trisolve_mod,
                                        "grouped_launches")},
    "hbmc_trisolve": {"on_chip": (_hbmc_trisolve_mod,
                                  "sweep_on_chip_launches"),
                      "plain": (_hbmc_trisolve_mod, "sweep_plain_launches"),
                      "wide": (_hbmc_trisolve_mod, "sweep_wide_launches"),
                      "grouped": (_hbmc_trisolve_mod,
                                  "sweep_grouped_launches")},
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in
            _COUNTED.items()}


def cuda_launch_counts() -> dict[str, int]:
    """CUDA launches per wrapper since the last reset, as the C entry points
    report them: one per segment of the trisolve kernels (B1, B3, B5,
    B6), one per call of B2 / B4 and of the shard steps.
    ``sell_spmv_block``'s launches are B2's or B4's, counted under both
    names."""
    return {name: getattr(mod, attr) for name, (mod, attr) in
            _CUDA_COUNTED.items()}


def operand_bytes() -> dict[str, int]:
    """Operand bytes per wrapper since the last reset: each tensor argument
    and the result once per outermost call, on the card and on the CPU
    (``_trace``); ``sell_spmv_block``'s calls count under its name only."""
    return {name: getattr(mod, attr) for name, (mod, attr) in
            _BYTES_COUNTED.items()}


def forwarding_counts() -> dict[str, dict[str, int]]:
    """CUDA launches of B1 (``hbmc_trisolve_fused``) and B5
    (``hbmc_trisolve``) since the last reset, split by path: ``on_chip``
    (a segment of at least ``segments.ON_CHIP_MIN_STEPS`` steps of a table
    of at most ``segments.ON_CHIP_MAX_K`` entries a row, whose reads of the
    launch's own writes are served on chip), ``plain`` (the plain path of
    such a table), ``wide`` (the plain path of a table of more than
    ``ON_CHIP_MAX_K`` entries a row, whose entries past it each step loads
    in the step) and ``grouped`` (the lane-group path of such a table, G =
    ``segments.lane_group(K, R)`` > 1 threads a lane); the four add up to
    the wrapper's ``cuda_launch_counts()``."""
    return {name: {path: getattr(mod, attr)
                   for path, (mod, attr) in paths.items()}
            for name, paths in _PATH_COUNTED.items()}


def _counters() -> tuple:
    return (*_COUNTED.values(), *_CUDA_COUNTED.values(),
            *_BYTES_COUNTED.values(),
            *(c for paths in _PATH_COUNTED.values() for c in paths.values()))


def reset_launch_counts() -> None:
    """Zero the wrapper-call, CUDA-launch, path and operand-byte
    counters, and clear ``segments.analysed()``."""
    for mod, attr in _counters():
        setattr(mod, attr, 0)
    segments.reset_analysed()


def _counter_values() -> dict[tuple, int]:
    """Every counter's value, keyed by (module, attribute)."""
    return {(mod, attr): getattr(mod, attr) for mod, attr in _counters()}


def _add_counter_values(delta: dict[tuple, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (from ``_counter_values`` differences) to
    the counters: a CUDA graph replay runs launches that no wrapper call
    issued (``core.device_loop``)."""
    for (mod, attr), d in delta.items():
        setattr(mod, attr, getattr(mod, attr) + times * d)
