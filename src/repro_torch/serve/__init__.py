"""Serving layer of the port: the solver service (``solver.py``), its
seeded fault injection (``faults.py``) and the LM steps (``step.py``).

``step`` is not imported here -- it pulls in ``repro_torch.models``; import
it explicitly (``from repro_torch.serve import step``), as in the
reference's ``repro.serve``.
"""
from .faults import FAULT_KINDS, FaultInjector, FaultPlan
from .solver import (DEFAULT_COSTS, SERVICE_STATUSES, CacheStats, Completed,
                     PlanBusyError, PlanCache, PlanKey, QueueFullError,
                     SolverService, VirtualClock, WallClock,
                     pattern_fingerprint, values_fingerprint)

__all__ = [
    "DEFAULT_COSTS", "FAULT_KINDS", "SERVICE_STATUSES", "CacheStats",
    "Completed", "FaultInjector", "FaultPlan", "PlanBusyError", "PlanCache",
    "PlanKey", "QueueFullError", "SolverService", "VirtualClock",
    "WallClock", "pattern_fingerprint", "values_fingerprint",
]
