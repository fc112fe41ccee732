"""Core library of the port: HBMC ordering + parallel ICCG on PyTorch.

The host-side setup modules (graph, matrices, coloring, hbmc, ic0, sell) are
numpy/scipy copies of the reference's; trisolve, iccg, plan and smoothers
run on a torch device, or sharded over a ``DeviceMesh`` axis; ``partition``
(imported on its own, as in the reference) holds the one-shot mesh solves.
"""
from .coloring import (BlockPartition, BMCOrdering, MCOrdering,
                       block_multicolor_ordering, build_blocks, color_blocks,
                       multicolor_ordering, pad_system)
from .graph import (check_er_condition, invert_perm, level_sets,
                    ordering_digraph_edges, permute_system)
from .hbmc import (HBMCOrdering, hbmc_from_bmc, hbmc_ordering,
                   pad_system_hbmc, verify_level2_structure)
from .ic0 import (FactorBreakdownError, IC0Structure, ic0, ic0_error,
                  ic0_refactor, ic0_rounds, ic0_structure,
                  sequential_ic_solve)
from .iccg import (BREAKDOWN, CONVERGED, DIVERGED, DIVERGENCE_FACTOR,
                   MAXITER, RUNNING, STAGNATED, STAGNATION_WINDOW,
                   STATUS_NAMES, UNHEALTHY_STATUSES, BatchedPCGResult,
                   PCGResult, SlabState, make_sharded_spmv, pcg, pcg_batched,
                   pcg_iteration, spmv_ell, spmv_ell_batched, spmv_sell,
                   spmv_sell_batched, status_name)
from .matrices import PAPER_PROBLEMS, PAPER_SHIFTS, paper_problem
from .plan import (ON_BREAKDOWN, SCHEDULERS, SPMV_FORMATS, BatchedICCGReport,
                   ICCGReport, SetupBreakdown, SolverPlan, build_plan)
from .sell import (FusedRoundMajorTables, PackingIndexError, RoundMajorLayout,
                   RoundMajorTables, SellMatrix, StepTables, fuse_round_major,
                   pack_ell, pack_factor, pack_factor_hbmc, pack_sell,
                   pack_steps, permute_round_major, round_major_layout,
                   rounds_bmc, rounds_hbmc, rounds_levelset, rounds_mc,
                   rounds_natural, to_round_major)
from .smoothers import GSSmoother, build_gs_smoother, gs_solve
from .solvers import solve_iccg, solve_iccg_batched
from .trisolve import (LAYOUTS, DeviceFusedTables, DeviceTables,
                       DistributedRoundMajorPreconditioner,
                       HBMCPreconditioner, RoundMajorPreconditioner,
                       backward_solve, backward_solve_batched,
                       build_preconditioner, build_preconditioner_from_rounds,
                       build_round_major_preconditioner,
                       build_round_major_preconditioner_from_rounds,
                       forward_solve, forward_solve_batched, fused_solve,
                       fused_solve_batched, sequential_backward,
                       sequential_forward, shard_fused_tables)
