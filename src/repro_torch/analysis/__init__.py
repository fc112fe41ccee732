"""Static analysis of the port: schedule races, kernel checks, contracts,
numerics and data movement.

Port of ``repro.analysis``.  Proves a plan race-free and contract-conforming
*before* its kernels run on the card:

  ``schedule``       dependency-DAG race detector over rounds, packed
                     trisolve tables and the IC(0) step schedule, with
                     machine-readable ``Violation`` witnesses; and
                     ``check_segments``, the proof that a table's cut into
                     kernel launches races nowhere on the card (the one
                     check the reference, whose TPU grid runs in order,
                     has no need of)
  ``kernel_checks``  static checks of the CUDA kernels' operands and launch
                     grids (int32 positions, int arguments, gridDim.x,
                     contiguity, gather bounds)
  ``contracts``      linter of the PyTorch dispatch stream with per-path op
                     budgets; kernel wrappers are opaque nodes
  ``dtype_flow``     the same stream against each path's
                     ``PrecisionContract``
  ``collectives``    one all-gather per fused step on a mesh, one per SpMV,
                     nothing else, from ``core.mesh``'s counters and the
                     dispatch stream
  ``traffic``        static bytes-per-iteration model, the kernels' bound
                     bytes measured through the wrappers, and the
                     ``bench-gate`` snapshot regression gate

The reference's ``hlo`` module (its optimized-HLO parser) has no
counterpart: the port compiles no HLO.  Of its three consumers,
``collectives`` and ``traffic`` are re-based here on the mesh's collective
counters, the dispatch stream and the bytes the kernel wrappers record;
the third, ``launch/`` (the roofline dry run), is ported in a later slice.
The reference's TPU VMEM budget has no counterpart either: the CUDA kernels
use no shared memory, and ``kernel_checks.plan_launches`` reports their
grids instead.

``build_plan(a, validate="cheap"|"full"|"deep")`` and
``serve.PlanCache(validate=...)`` run the detector at setup and admission;
``python -m repro_torch.analysis`` audits matrices, orderings and plans from
the command line, and ``python -m repro_torch.analysis bench-gate`` gates
bench runs against the committed ``BENCH_*.json`` snapshots.
"""
from .collectives import (FORBIDDEN_COLLECTIVES, assert_plan_collectives,
                          check_collectives, check_plan_collectives)
from .contracts import (DISTRIBUTED_APPLY, FULL_PALLAS_ITERATION,
                        PALLAS_SPMV, PRECONDITIONED_ITERATION,
                        ROUND_MAJOR_APPLY, ContractError, OpRecorder,
                        PrimitiveBudget, assert_budget, lint,
                        primitive_counts, recaptures)
from .dtype_flow import (PrecisionContract, assert_plan_dtype_flow,
                         check_plan_dtype_flow, contract_for_plan,
                         lint_dtype_flow)
from .kernel_checks import (assert_plan_kernels, check_plan_kernels,
                            check_sell_spmv, check_shard_step,
                            check_trisolve_fused, check_trisolve_sweep,
                            plan_launches)
from .schedule import (VALIDATE_MODES, ScheduleError, Violation,
                       assert_plan_valid, check_fused_tables,
                       check_ic0_structure, check_reversed_rounds,
                       check_rounds, check_segments, check_shard_block,
                       check_step_tables, sweep_step_tables, validate_plan)
from .traffic import (TrafficReport, TrafficTerm, assert_plan_traffic,
                      bench_gate, bound, check_plan_traffic, compare_traffic,
                      spmv_bytes, traffic_report, trisolve_bytes)

__all__ = [
    "DISTRIBUTED_APPLY", "FULL_PALLAS_ITERATION", "PALLAS_SPMV",
    "PRECONDITIONED_ITERATION", "ROUND_MAJOR_APPLY", "ContractError",
    "OpRecorder", "PrimitiveBudget", "assert_budget", "lint",
    "primitive_counts", "recaptures",
    "PrecisionContract", "assert_plan_dtype_flow", "check_plan_dtype_flow",
    "contract_for_plan", "lint_dtype_flow",
    "FORBIDDEN_COLLECTIVES", "assert_plan_collectives", "check_collectives",
    "check_plan_collectives",
    "TrafficReport", "TrafficTerm", "assert_plan_traffic", "bench_gate",
    "bound", "check_plan_traffic", "compare_traffic", "spmv_bytes",
    "traffic_report", "trisolve_bytes",
    "assert_plan_kernels", "check_plan_kernels", "check_sell_spmv",
    "check_shard_step", "check_trisolve_fused", "check_trisolve_sweep",
    "plan_launches",
    "VALIDATE_MODES", "ScheduleError", "Violation", "assert_plan_valid",
    "check_fused_tables", "check_ic0_structure", "check_reversed_rounds",
    "check_rounds", "check_segments", "check_shard_block",
    "check_step_tables", "sweep_step_tables", "validate_plan",
]
