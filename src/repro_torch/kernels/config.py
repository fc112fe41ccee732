"""Device resolution for the port's entry points.

Replaces ``repro.kernels.config.resolve_interpret``: where the reference
picked compiled-vs-interpreted Pallas from the JAX backend, the port picks
the device explicitly.  ``"cuda"`` is the default and raises when no CUDA
device is present -- a solve never drops to the CPU on its own.  The CPU
runs the kernels' plain PyTorch versions and is chosen by passing
``device="cpu"`` (the CPU tests do).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE, *,
                   meta: bool = False) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it cannot run here.

    Only ``cuda`` and ``cpu`` devices are accepted, and ``meta`` where the
    caller passes ``meta=True``: the LM stack's entry points, for the
    dry-run's abstract step (shapes only, nothing allocated or computed).
    A CUDA device on a machine without one raises ``RuntimeError``.
    """
    dev = torch.device(device)
    if meta and dev.type == "meta":
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; expected 'cuda' "
                         "or 'cpu'")
    return dev


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper given ``t`` runs its plain PyTorch version
    (``t`` on the CPU) rather than launching its CUDA kernel (``t`` on the
    card); any other device raises ``ValueError``."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"
