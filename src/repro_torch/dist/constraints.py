"""Sharding-constraint annotations for model code (port of
``repro.dist.constraints``).

``constrain(x, spec0, spec1, ...)`` is the reference's
``lax.with_sharding_constraint`` with its three conveniences, over DTensor:

  * when no mesh is active, or ``x`` is not a DTensor, it is the identity;
  * the ``BATCH`` sentinel expands to whichever batch-like mesh axes
    ("pod", "data") exist, largest combination that divides the dimension;
  * any entry naming an axis that is absent from the mesh, or that does not
    divide the corresponding dimension, is dropped (replaced by ``None``)
    instead of erroring -- e.g. the sequence-parallel ``"model"`` entry
    degrades gracefully at decode time when S == 1.

Otherwise ``x`` is redistributed to the resolved placements, and in the
backward its gradient is placed there too before it flows on (the
reference's constraint transposes to the same constraint on the
cotangent).

``use_mesh(mesh)`` is the counterpart of the reference's ``with mesh:``: it
makes ``mesh`` the active mesh, and inside it a plain tensor that meets a
DTensor counts as replicated (``implicit_replication``): the positions,
masks, RoPE tables and zeros the models make, and the optimizer's
schedule scalars, hold the same value on every rank.  Both are process
wide, not per thread, so the backward (which runs on another thread on a
GPU) and the recompute of a remat block see them too.
"""
from __future__ import annotations

import contextlib
import math

from .sharding import _axis_sizes, _batch_entry, placements


class _BatchSentinel:
    """Marker for 'the batch axis of the mesh, whatever it is named'."""
    def __repr__(self):
        return "BATCH"


BATCH = _BatchSentinel()

_active_mesh = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh inside the block,
    with plain tensors counting as replicated (module docstring)."""
    global _active_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _active_mesh
    _active_mesh = mesh
    try:
        if prev is None:
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _active_mesh = prev


def _current_mesh():
    """The mesh of the enclosing ``use_mesh``, or None outside of one."""
    return _active_mesh


def divides(axis: str, n: int) -> bool:
    """Whether the active mesh has ``axis`` and its size divides ``n``."""
    mesh = _current_mesh()
    return mesh is not None and _resolve_entry(axis, n, mesh) is not None


def _resolve_entry(entry, dim: int, mesh):
    """One spec entry -> validated entry (or None if indivisible)."""
    if entry is None:
        return None
    if isinstance(entry, _BatchSentinel):
        return _batch_entry(mesh, dim)
    sizes = _axis_sizes(mesh)
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    if not all(a in sizes for a in axes):
        return None
    if dim % math.prod(sizes[a] for a in axes) != 0:
        return None
    return entry


def constrain(x, *entries):
    if len(entries) != x.ndim:
        raise ValueError(f"constrain: {len(entries)} entries for rank-"
                         f"{x.ndim} array")
    mesh = _current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    spec = tuple(_resolve_entry(e, d, mesh)
                 for e, d in zip(entries, x.shape))
    want = placements(mesh, spec)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return _grad_placed(x, want)


def _grad_placed(x, want):
    """``x`` itself in the forward; the backward places the gradient at
    ``want`` first, as the reference's constraint (whose transpose
    constrains the cotangent to the same spec) -- ``redistribute``'s own
    backward only restores its input's placements."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(grad_placements=want),
                              x.device_mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
