"""Production mesh construction (port of ``repro.launch.mesh``).

Defined as functions (never module-level constants), so importing this
module touches no process group.  The meshes are built over the current
``torch.distributed`` process group: on the cards, one rank per GPU; in the
dry-run, a fake process group of 256 or 512 ranks (``launch/dryrun.py``),
the counterpart of the reference's 512 forced host devices.
"""
from __future__ import annotations

import math

import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16 x 16 = 256 devices per pod ("data", "model"); 2 pods = 512 when
    ``multi_pod`` ("pod", "data", "model").  Raises when the process group
    is smaller; a larger one lends the mesh its first ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < need:
        raise RuntimeError(
            f"need {need} ranks, found {world} -- run under a process group "
            f"of at least {need} ranks (launch/dryrun.py makes a fake one)")
    import torch
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_host_mesh(device_type="cuda"):
    """Degenerate 1 x 1 ("data", "model") mesh over a one-rank group, for
    the sharded code paths on one device."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM hardware model used by the roofline analysis (the
# reference's is a TPU v5e)
HW = dict(
    peak_flops=989e12,      # dense bf16 FLOP/s per GPU (spec sheet)
    hbm_bw=3.35e12,         # HBM3 bytes/s per GPU (spec sheet)
    # NVLink 4: 900 GB/s per GPU bidirectional, 450 GB/s each way (H100
    # SXM spec sheet) -- within one 8-GPU node.  A 256- or 512-GPU mesh
    # spans nodes, whose links (InfiniBand, ~50 GB/s per GPU each way)
    # are ~9x slower: the collective term is a lower bound there.
    ici_bw=450e9,
    hbm_bytes=80e9,         # 80 GB per GPU
)
