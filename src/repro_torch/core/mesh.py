"""The port's mesh: one axis of a ``torch.distributed`` ``DeviceMesh``.

The reference shards its plan over a ``jax.sharding.Mesh`` axis inside
``shard_map``; the port runs the same program on every rank of a
``DeviceMesh`` (SPMD: every rank builds the plan from the same matrix and
solves the same right-hand side) and each rank keeps only its block of the
sharded operands.  ``axis_group`` gives one axis's process group, size and
this rank's place on it; ``all_gather_`` is the one collective of the mesh
path, counted per caller so that a run can show how many it issued
(``gather_counts``; ``core.device_loop`` adds a replayed block's
collectives to them as it adds its kernel launches).

torch API notes: ``DeviceMesh.size(name)`` is not accepted by every torch
version, so the axis size is the size of the axis's group; and
``all_gather_into_tensor`` is called by that name (newer torch versions
warn that it is deprecated, older ones lack the new name).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: all-gathers issued by the mesh trisolve and by the mesh SpMV since the
#: last reset (replayed graphs included)
trisolve_gathers = 0
spmv_gathers = 0
_COUNTERS = ("trisolve_gathers", "spmv_gathers")


def gather_counts() -> dict[str, int]:
    """All-gathers since the last reset: ``{"trisolve": n, "spmv": n}``."""
    return {"trisolve": trisolve_gathers, "spmv": spmv_gathers}


def reset_gather_counts() -> None:
    global trisolve_gathers, spmv_gathers
    trisolve_gathers = spmv_gathers = 0


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
    name = f"{who}_gathers"
    if name not in _COUNTERS:
        raise ValueError(f"unknown caller {who!r}")
    dist.all_gather_into_tensor(out, chunk, group=group)
    globals()[name] += 1
    return out
