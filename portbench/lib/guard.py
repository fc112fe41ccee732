"""The look for JAX: no module of the JAX stack, nor the JAX package this
port was made from, may be loaded in a run's process.  Names compare by
their top level, whole: ``repro_torch`` is the port, ``repro`` is not."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})
