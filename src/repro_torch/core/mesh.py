"""The port's mesh: one axis of a ``torch.distributed`` ``DeviceMesh``.

The reference shards its plan over a ``jax.sharding.Mesh`` axis inside
``shard_map``; the port runs the same program on every rank of a
``DeviceMesh`` (SPMD: every rank builds the plan from the same matrix and
solves the same right-hand side) and each rank keeps only its block of the
sharded operands.  ``axis_group`` gives one axis's process group, size and
this rank's place on it; ``all_gather_`` is the one collective of the mesh
path, counted per caller in ``spans``' counters so that a run can show how
many it issued (``gather_counts``; replayed blocks included).  ``gather_lanes``
assembles a lane-sharded table from every rank's block, for the static
checks of a built mesh plan (``analysis.validate_plan``); it is not on the
solve path and is not counted.

torch API notes: ``DeviceMesh.size(name)`` is not accepted by every torch
version, so the axis size is the size of the axis's group; and
``all_gather_into_tensor`` is called by that name (newer torch versions
warn that it is deprecated, older ones lack the new name).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..spans import count, counts, reset_counts

#: the callers of ``all_gather_``: the mesh trisolve and the mesh SpMV
_CALLERS = ("trisolve", "spmv")


def gather_counts() -> dict[str, int]:
    """All-gathers since the last reset: ``{"trisolve": n, "spmv": n}``."""
    got = counts("mesh.gathers.")
    return {who: got.get(who, 0) for who in _CALLERS}


def reset_gather_counts() -> None:
    reset_counts("mesh.")


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's dimension names (empty when it has none)."""
    return tuple(mesh.mesh_dim_names or ())


def axis_group(mesh, axis: str) -> tuple[dist.ProcessGroup, int, int]:
    """(process group, size, this rank's index) of mesh axis ``axis``."""
    if axis not in axis_names(mesh):
        raise ValueError(f"mesh has no axis {axis!r}; axes are "
                         f"{axis_names(mesh)}")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def all_gather_(out: torch.Tensor, chunk: torch.Tensor,
                group: dist.ProcessGroup, who: str) -> torch.Tensor:
    """Gather every rank's ``chunk`` into ``out`` along dim 0, in rank order
    (``chunk`` may be this rank's own block of ``out``: in place); counts
    one all-gather for ``who`` (``"trisolve"`` or ``"spmv"``)."""
    if who not in _CALLERS:
        raise ValueError(f"unknown caller {who!r}")
    dist.all_gather_into_tensor(out, chunk, group=group)
    count(f"mesh.gathers.{who}")
    return out


def gather_lanes(block: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The whole table of which ``block`` is this rank's lane block: every
    rank's block of dim 1 gathered over ``axis`` in rank order, as
    ``trisolve.shard_fused_tables`` cut them.  ``block`` is (steps, r_loc,
    ...); returns (steps, size * r_loc, ...).  SPMD: every rank of the axis
    must call it.  Not counted in ``gather_counts``."""
    group, size, _ = axis_group(mesh, axis)
    rest = tuple(block.shape[2:])
    out = block.new_empty((size * block.shape[0],) + tuple(block.shape[1:]))
    dist.all_gather_into_tensor(out, block.contiguous(), group=group)
    return (out.reshape((size,) + tuple(block.shape)).movedim(0, 1)
            .reshape((block.shape[0], size * block.shape[1]) + rest)
            .contiguous())
