"""PyTorch/CUDA port of the HBMC-ordered ICCG solver.

Sits beside the JAX package ``repro``, which stays the reference.  The
port imports torch, numpy and scipy -- never JAX and nothing of ``repro``.
Entry points take an explicit ``device`` (default ``"cuda"``, which raises
without a CUDA device); the hand-written CUDA kernels run for tensors on the
card, their plain PyTorch versions for tensors on the CPU.
"""
from .core import SolverPlan, build_plan, solve_iccg, solve_iccg_batched
