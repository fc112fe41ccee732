"""Roofline terms of one dry-run cell (port of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_device / peak_FLOPs_per_GPU
    memory     = bytes_per_device / HBM_bw_per_GPU
    collective = collective_wire_bytes_per_device / link_bw

over one rank's op record of the step (``analysis.op_cost``: local
shards, so the global work is already divided by the partitioning) and the
H100's ``HW`` (``launch/mesh.py``).

Memory fields: the reference reads XLA's ``memory_analysis()``; the port
has the step's arguments and outputs as local shards, so it reports
``argument_size_in_bytes`` (one rank's shards of the step's inputs) and
``output_size_in_bytes`` (of its outputs).  A temporary-bytes figure needs
an allocator, which the meta device has not, so ``temp_size_in_bytes`` is
left out, as is ``generated_code_size_in_bytes`` (nothing is compiled).
"""
from __future__ import annotations

from ..analysis.op_cost import COLL_WIRE, COLLECTIVES
from .mesh import HW

__all__ = ["COLL_WIRE", "COLLECTIVES", "roofline_terms"]


def roofline_terms(record: dict, model_flops_global: float, chips: int,
                   memory: dict | None = None) -> dict:
    """All three terms and the bookkeeping, from an ``op_cost`` record.
    ``memory``: ``argument_size_in_bytes`` / ``output_size_in_bytes`` of
    the step's local shards, copied into the result."""
    flops = record["flops"]
    t_compute = flops / HW["peak_flops"]
    t_memory = record["bytes"] / HW["hbm_bw"]
    t_coll = record["collective_wire_bytes"] / HW["ici_bw"]
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda t: t[1])[0]
    mf_per_dev = model_flops_global / chips
    bound = max(t_compute, t_memory, t_coll)
    out = {
        "flops_per_device": flops,
        "bytes_per_device": record["bytes"],
        "collective_bytes_per_device": record["collective_wire_bytes"],
        "collective_counts": record["collective_counts"],
        "collective_bytes_by_kind": record["collective_bytes_by_kind"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_device": mf_per_dev,
        "useful_flops_ratio": (mf_per_dev / flops) if flops else 0.0,
        "roofline_bound_s": bound,
        # fraction of the roofline bound spent on useful model math -- the
        # headline score: 1.0 = perfectly compute-bound on useful FLOPs
        "roofline_fraction": (mf_per_dev / HW["peak_flops"]) / bound
        if bound else 0.0,
    }
    out.update(memory or {})
    return out
