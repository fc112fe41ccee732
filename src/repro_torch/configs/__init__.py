"""Architecture registry: exact assigned configs + reduced smoke variants.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` a tiny same-family variant for CPU tests.
The port's own copy of ``repro.configs``, field for field, over the port's
``ArchConfig``.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "olmoe-1b-7b", "mixtral-8x22b", "recurrentgemma-2b", "stablelm-12b",
    "qwen3-14b", "llama3-405b", "qwen2.5-3b", "qwen2-vl-72b",
    "musicgen-medium", "mamba2-130m",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __name__)
    return mod.CONFIG


def get_smoke_config(arch_id: str):
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __name__)
    return mod.SMOKE_CONFIG


# ---------------------------------------------------------------------------
# input shapes assigned to the LM pool (seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SWA / local-attn / SSM archs
SUBQUADRATIC = {"mixtral-8x22b", "recurrentgemma-2b", "mamba2-130m"}


def cells():
    """All (arch, shape) dry-run cells, with skip annotations."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES.values():
            skip = (s.name == "long_500k" and a not in SUBQUADRATIC)
            out.append((a, s.name, skip))
    return out
