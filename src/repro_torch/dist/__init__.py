"""Mesh-aware sharding rules and sharding-constraint helpers (port of
``repro.dist``), over DTensor on a ``torch.distributed`` ``DeviceMesh``.

Two small modules with no model knowledge:

  * ``constraints`` -- ``constrain(x, ...)`` annotations used inside model
    code; no-ops when no mesh is active (``use_mesh``) or ``x`` is not a
    DTensor, and silently drop any axis that would not divide evenly (so
    the same model code runs on 1..N devices).
  * ``sharding``    -- the greedy parameter/batch/cache partition rules used
    by the launcher and the dry-run, and ``placements`` (a spec as DTensor
    placements).
"""
from .constraints import BATCH, constrain, use_mesh
from .sharding import (NamedSharding, batch_partition_spec,
                       cache_partition_spec, distribute, distribute_params,
                       param_partition_spec, params_shardings, placements)
