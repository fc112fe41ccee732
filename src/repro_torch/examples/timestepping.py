"""Implicit time stepping on ONE SolverPlan: factor once, solve many (twin
of ``examples/timestepping.py``).

The parabolic_fem workload (paper §5): each implicit Euler step of
u_t = div(grad u) solves  (I + dt * L) u_{k+1} = u_k  against the SAME
matrix.  A cold ``solve_iccg`` would redo ordering + IC(0) + packing every
step; a ``SolverPlan`` pays setup once and each subsequent step is a replay
of the captured PCG loop on the device.  When dt changes mid-run the
pattern of I + dt*L is unchanged, so ``plan.refactor`` renews only the
numeric factorization.

    PYTHONPATH=src python -m repro_torch.examples.timestepping [--device cpu]
"""
import time

import numpy as np
import scipy.sparse as sp

from ..core import build_plan, solve_iccg
from ..core.matrices import laplace_2d
from . import device_parser


def stepping_matrix(lap: sp.csr_matrix, dt: float) -> sp.csr_matrix:
    n = lap.shape[0]
    a = (sp.identity(n, format="csr") + dt * lap).tocsr()
    a.sort_indices()
    return a


def main(argv=None) -> dict:
    args = device_parser(__doc__).parse_args(argv)
    nx = ny = 64
    lap = laplace_2d(nx, ny)
    n = lap.shape[0]
    dt = 0.25
    n_steps = 20

    # initial condition: a hot square in the middle
    u = np.zeros((ny, nx))
    u[ny // 4: 3 * ny // 4, nx // 4: 3 * nx // 4] = 1.0
    u = u.ravel()

    a = stepping_matrix(lap, dt)
    t0 = time.perf_counter()
    plan = build_plan(a, method="hbmc", block_size=16, w=8,
                      device=args.device)
    setup_s = time.perf_counter() - t0
    print(f"n = {n}: plan setup {setup_s*1e3:.1f} ms "
          f"(ordering {plan.timings.ordering*1e3:.1f} / "
          f"factor {plan.timings.factor*1e3:.1f} / "
          f"pack {plan.timings.pack*1e3:.1f})")

    total_solve = 0.0
    iters = []
    refactor_s = None
    for k in range(n_steps):
        if k == n_steps // 2:
            # halfway: shrink the time step -> same pattern, new values.
            # refactor renews ONLY the numeric factorization + repack.
            dt /= 2
            t0 = time.perf_counter()
            plan.refactor(stepping_matrix(lap, dt))
            refactor_s = time.perf_counter() - t0
            print(f"step {k:2d}: dt -> {dt}  (refactor "
                  f"{refactor_s*1e3:.1f} ms vs "
                  f"{setup_s*1e3:.1f} ms full setup)")
        rep = plan.solve(u, rtol=1e-8)
        u = rep.x
        iters.append(rep.result.iterations)
        total_solve += rep.solve_seconds

    energy = float(np.linalg.norm(u))
    print(f"{n_steps} implicit steps: {total_solve*1e3:.1f} ms total solve, "
          f"iterations/step {min(iters)}..{max(iters)}")
    print(f"energy drained to {energy:.4f} "
          f"(from {np.linalg.norm(np.ones(n//4)):.4f}-ish)")

    # the cold-path comparison: what every step WOULD have paid
    t0 = time.perf_counter()
    solve_iccg(stepping_matrix(lap, dt), u, method="hbmc",
               block_size=16, w=8, rtol=1e-8, device=args.device)
    cold_s = time.perf_counter() - t0
    warm_s = total_solve / n_steps
    print(f"cold solve_iccg per step: {cold_s*1e3:.1f} ms; "
          f"warm plan.solve per step: {warm_s*1e3:.1f} ms "
          f"({cold_s/warm_s:.1f}x)")
    return dict(n=n, iterations=iters, energy=energy, u=u, setup_s=setup_s,
                refactor_s=refactor_s, cold_s=cold_s, warm_s=warm_s)


if __name__ == "__main__":
    main()
