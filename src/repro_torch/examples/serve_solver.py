"""Solver-as-a-service: many time-stepping clients, one cached plan (twin of
``examples/serve_solver.py``).

Six implicit-Euler heat-equation clients march (I + dt*L) x_{k+1} = x_k
on the same grid.  Every client shares one sparsity pattern, so the
service factors the matrix **once** (one cache miss); each subsequent
solve is a cache hit packed into a shared slab of width 4.  Halfway
through, every client shrinks its time step -- same pattern, new values --
and the cache renews the factorization in place (``refactor``: no
reordering, no new graph capture) instead of building a new plan.

    PYTHONPATH=src python -m repro_torch.examples.serve_solver [--device cpu]
"""
import numpy as np
import scipy.sparse as sp

from ..core.matrices import laplace_2d
from ..serve import PlanCache, SolverService
from . import device_parser


def heat_matrix(grid, dt):
    lap = laplace_2d(grid, grid)
    return (sp.eye(lap.shape[0], format="csr") + dt * lap).tocsr()


def main(argv=None) -> dict:
    args = device_parser(__doc__).parse_args(argv)
    grid, n_clients, n_steps = 24, 6, 8
    a = heat_matrix(grid, dt=0.5)
    rng = np.random.default_rng(0)

    svc = SolverService(PlanCache(capacity=4), slab_width=4, quantum=16,
                        method="hbmc", block_size=16, w=8,
                        device=args.device)
    # each client starts from its own random temperature field
    fields = [rng.random(a.shape[0]) for _ in range(n_clients)]

    print(f"{n_clients} clients x {n_steps} steps on a {grid}x{grid} grid "
          f"(n = {a.shape[0]}), slab width 4\n")
    steps = []
    for step in range(n_steps):
        if step == n_steps // 2:
            a = heat_matrix(grid, dt=0.1)   # new values, same pattern
            print("  -- all clients shrink dt: cache refactors in place --")
        rids = {svc.submit(a, fields[c], tag=c): c
                for c in range(n_clients)}
        done = svc.drain()
        for c in done:
            fields[rids[c.rid]] = c.x
        iters = sorted({c.iterations for c in done})
        status = {c.plan_status for c in done}
        steps.append(dict(solves=len(done), iterations=iters,
                          plan=sorted(status)))
        print(f"  step {step}: {len(done)} solves, iterations {iters}, "
              f"plan {sorted(status)}")

    s = svc.cache.stats
    energy = float(np.mean([np.linalg.norm(f) for f in fields]))
    print(f"\ncache: {s.hits} hits, {s.misses} miss, "
          f"{s.refactors} refactor, hit rate {s.hit_rate:.2f} "
          f"-- {n_clients * n_steps} solves, 1 factorization built")
    print(f"mean field energy: {energy:.4f}")
    return dict(steps=steps, hits=s.hits, misses=s.misses,
                refactors=s.refactors, hit_rate=s.hit_rate, fields=fields,
                energy=energy)


if __name__ == "__main__":
    main()
