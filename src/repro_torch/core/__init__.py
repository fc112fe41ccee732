"""Core library of the port: HBMC ordering + parallel ICCG on PyTorch.

The host-side setup modules (graph, matrices, coloring, hbmc, ic0, sell) are
numpy/scipy copies of the reference's; trisolve, iccg and plan run the
solve on a torch device.
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
                   STATUS_NAMES, UNHEALTHY_STATUSES, PCGResult, pcg,
                   spmv_sell, status_name)
from .matrices import PAPER_PROBLEMS, PAPER_SHIFTS, paper_problem
from .plan import (ON_BREAKDOWN, SCHEDULERS, ICCGReport, SetupBreakdown,
                   SolverPlan, build_plan)
from .sell import (FusedRoundMajorTables, PackingIndexError, RoundMajorLayout,
                   SellMatrix, StepTables, fuse_round_major, pack_factor,
                   pack_sell, pack_steps, permute_round_major, rounds_bmc,
                   rounds_hbmc, rounds_levelset, rounds_mc, rounds_natural)
from .solvers import solve_iccg
from .trisolve import (DeviceFusedTables, RoundMajorPreconditioner,
                       build_round_major_preconditioner_from_rounds,
                       fused_solve)
