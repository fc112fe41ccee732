"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

hbmc_trisolve -- the fused forward+backward HBMC sweep, the IC(0) apply
(``csrc/hbmc_trisolve.cu``; replaces the Pallas ``hbmc_trisolve_fused``).

sell_spmv -- the SELL-w SpMV (``csrc/sell_spmv.cu``; replaces the Pallas
``sell_spmv``).

Each wrapper runs its CUDA kernel for a CUDA tensor and its plain version
(``ref.py``) for a CPU tensor, and counts its kernel launches.
"""
from . import hbmc_trisolve as _hbmc_trisolve_mod
from . import sell_spmv as _sell_spmv_mod
from .config import DEFAULT_DEVICE, resolve_device
from .hbmc_trisolve import hbmc_trisolve_fused
from .ref import hbmc_trisolve_fused_ref, sell_spmv_ref, take_fill0
from .sell_spmv import sell_spmv

_COUNTED = {"hbmc_trisolve_fused": _hbmc_trisolve_mod,
            "sell_spmv": _sell_spmv_mod}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
