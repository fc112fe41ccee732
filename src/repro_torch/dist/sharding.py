"""Greedy, divisibility-safe partition rules for params, batches and caches
(port of ``repro.dist.sharding``).

The contract (held by tests/test_torch_sharding.py against the reference):

  * a spec NEVER names mesh axes whose product does not divide the
    corresponding array dimension;
  * large matrices are both tensor-parallel ("model" axis) and FSDP
    ("data" axis) sharded: "model" goes to the largest divisible dim,
    "data" to the largest remaining divisible dim.

A spec is a tuple with one entry per dimension: ``None``, an axis name, or
a tuple of axis names (the reference's ``PartitionSpec``).  ``placements``
turns it into DTensor placements on a ``DeviceMesh``.

``mesh`` is a ``torch.distributed`` ``DeviceMesh`` (its ``mesh_dim_names``
are the axis names) or any object with ``.axis_names`` and
``.devices.shape`` (the reference's lightweight stand-in), so specs can be
computed for 256 or 512 devices without a process group.

**Per-layer leaves.**  The reference stacks each pattern slot's leaves over
the repeats, ``(R, ...)``; the port keeps one module per layer.  The spec
of a per-layer leaf is the reference's spec of the stacked leaf with the
stack entry removed (``repeats=R``), so where the reference puts an axis on
the stack dimension the port replicates the leaf over that axis
(``stack_replicated``).
"""
from __future__ import annotations

import dataclasses
import math


def _axis_sizes(mesh) -> dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # a torch DeviceMesh
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _place(shape, axis_size: int, taken: set[int]) -> int | None:
    """Largest dim (not yet taken) divisible by axis_size; None if none."""
    order = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in order:
        if d in taken or shape[d] <= 1:
            continue
        if shape[d] % axis_size == 0:
            return d
    return None


def param_partition_spec(path, leaf, mesh, repeats: int | None = None
                         ) -> tuple:
    """Greedy TP+FSDP rule for one parameter leaf.

    "model" shards the largest divisible dimension (tensor parallelism),
    "data" the largest remaining divisible dimension (FSDP).  Dims of size
    <= 1 and indivisible dims stay replicated.  ``path`` is accepted for
    rule refinements but the base rule is shape-only.  ``repeats``: the
    leaf is one layer of a slot stacked over that many repeats in the
    reference; the rule runs on the stacked shape and the stack entry is
    dropped.
    """
    shape = tuple(leaf.shape)
    if repeats is None:
        return _greedy_spec(shape, mesh)
    return _greedy_spec((repeats,) + shape, mesh)[1:]


def _greedy_spec(shape: tuple, mesh) -> tuple:
    if len(shape) == 0:
        return ()
    sizes = _axis_sizes(mesh)
    spec: list = [None] * len(shape)
    taken: set[int] = set()
    for axis in ("model", "data"):
        if axis not in sizes:
            continue
        d = _place(shape, sizes[axis], taken)
        if d is not None:
            spec[d] = axis
            taken.add(d)
    return tuple(spec)


def layer_repeats(name: str, cfg) -> int | None:
    """The reference's stack size of parameter ``name`` (its pattern
    repeats for a block leaf, None for a top-level leaf)."""
    return cfg.pattern_repeats if name.startswith("blocks.") else None


def stack_replicated(name: str, leaf, mesh, cfg) -> str | None:
    """The axis the reference puts on the stack dimension of the block
    leaf ``name`` (the port replicates the per-layer leaf over it), or
    None."""
    r = layer_repeats(name, cfg)
    return None if r is None else _greedy_spec((r,) + tuple(leaf.shape),
                                               mesh)[0]


def stack_replicated_report(model, mesh) -> list[dict]:
    """The block leaves of ``model`` (one per pattern slot) that the
    reference shards over its stack dimension: ``{"slot", "leaf",
    "shape", "axis", "bytes_added"}``, where ``bytes_added`` is what the
    port's per-layer leaves hold per device beyond the reference's stacked
    leaf, summed over the repeats."""
    cfg = model.cfg
    sizes = _axis_sizes(mesh)
    out = []
    for name, p in model.named_parameters():
        if not name.startswith("blocks."):
            continue
        _, layer, leaf = name.split(".", 2)
        if int(layer) >= len(cfg.block_pattern):
            continue                    # the first repeat stands for all
        axis = stack_replicated(name, p, mesh, cfg)
        if axis is None:
            continue
        spec = param_partition_spec(name, p, mesh, cfg.pattern_repeats)
        rest = math.prod(sizes[a] for e in spec if e
                         for a in ((e,) if isinstance(e, str) else e))
        stacked = cfg.pattern_repeats * p.numel() * p.element_size()
        out.append({"slot": int(layer), "leaf": leaf,
                    "shape": tuple(p.shape), "axis": axis,
                    "bytes_added": stacked / rest * (1 - 1 / sizes[axis])})
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: mesh
    dim ``a`` shards the tensor dim whose entry names ``a``, else it
    replicates.  A tuple entry shards one dim over several mesh dims, which
    must come in the mesh's order (DTensor splits major to minor).  A mesh
    dim of size 1 replicates (``mesh_placement``)."""
    from torch.distributed.tensor import Shard
    names = tuple(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"axis {a!r} named twice in {spec}")
            where[a] = d
    return tuple(mesh_placement(mesh, a, Shard(where[a])) if a in where
                 else mesh_placement(mesh, a, None) for a in names)


def mesh_placement(mesh, axis: str, placement):
    """``placement`` on mesh dim ``axis`` (None: replicate), but
    ``Replicate()`` where the dim has size 1: one shard or one partial sum
    is the whole tensor there, and torch's DTensor rules refuse some views
    of a dim sharded even over one device."""
    from torch.distributed.tensor import Replicate
    if placement is None or _axis_sizes(mesh)[axis] == 1:
        return Replicate()
    return placement


def params_shardings(model, mesh) -> dict[str, NamedSharding]:
    """``NamedSharding`` of every parameter of ``model`` (a ``Model``, or
    one on the meta device from ``param_specs``), by name."""
    cfg = model.cfg
    return {name: NamedSharding(mesh, param_partition_spec(
                name, p, mesh, layer_repeats(name, cfg)))
            for name, p in model.named_parameters()}


def _batch_entry(mesh, batch: int):
    """Batch-dim entry: largest ("pod","data") combination dividing batch."""
    sizes = _axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    while axes and batch % math.prod(sizes[a] for a in axes) != 0:
        axes = axes[1:]
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_partition_spec(mesh, batch: int, ndim: int) -> tuple:
    """Shard the leading (batch) dim over the data-like axes; rest
    replicated."""
    return (_batch_entry(mesh, batch),) + (None,) * (ndim - 1)


def cache_partition_spec(mesh, leaf, batch: int) -> tuple:
    """Decode-cache rule: shard the first dimension of size ``batch``.  The
    port's cache is per layer, so batch is its leading dim (the reference's
    stacked cache has the repeats before it)."""
    spec: list = [None] * len(leaf.shape)
    for d, size in enumerate(leaf.shape):
        if size == batch:
            spec[d] = _batch_entry(mesh, batch)
            break
    return tuple(spec)


def distribute(t, sharding: NamedSharding):
    """``t`` (the same whole tensor on every rank) as a DTensor placed by
    ``sharding``: the reference's ``jax.device_put(x, sharding)``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements)


def distribute_params(model, shardings: dict[str, NamedSharding]):
    """Replace every parameter of ``model`` by its DTensor placed by
    ``shardings[name]`` (``params_shardings``), in place; returns
    ``model``."""
    from torch import nn
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        setattr(owner, leaf, nn.Parameter(
            distribute(p.detach(), shardings[name]),
            requires_grad=p.requires_grad))
    return model

