"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

hbmc_trisolve -- the fused forward+backward HBMC sweep, the IC(0) apply,
single-RHS and batched (``csrc/hbmc_trisolve.cu``; replaces the Pallas
``hbmc_trisolve_fused`` and ``hbmc_trisolve_fused_batched``).

sell_spmv -- the SELL-w SpMV, single-RHS and batched (``csrc/sell_spmv.cu``;
replaces the Pallas ``sell_spmv`` and ``sell_spmv_batched``).

Each wrapper runs its CUDA kernel for a CUDA tensor and its plain version
(``ref.py``) for a CPU tensor, and counts its kernel launches.
"""
from . import hbmc_trisolve as _hbmc_trisolve_mod
from . import sell_spmv as _sell_spmv_mod
from .config import DEFAULT_DEVICE, resolve_device
from .hbmc_trisolve import hbmc_trisolve_fused, hbmc_trisolve_fused_batched
from .ref import (hbmc_trisolve_fused_batched_ref, hbmc_trisolve_fused_ref,
                  sell_spmv_batched_ref, sell_spmv_ref, take_fill0)
from .sell_spmv import sell_spmv, sell_spmv_batched

# wrapper name -> (module, counter attribute)
_COUNTED = {
    "hbmc_trisolve_fused": (_hbmc_trisolve_mod, "launches"),
    "sell_spmv": (_sell_spmv_mod, "launches"),
    "hbmc_trisolve_fused_batched": (_hbmc_trisolve_mod, "batched_launches"),
    "sell_spmv_batched": (_sell_spmv_mod, "batched_launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in
            _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)
