"""Serving layer of the port: the solver service (``solver.py``) and its
seeded fault injection (``faults.py``).

Port of ``repro.serve`` without ``step`` (the LM stack's decode steps,
which come with the port's LM slice).
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
