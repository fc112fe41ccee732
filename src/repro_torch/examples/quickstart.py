"""Quickstart: the paper's solver in a screenful (twin of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import numpy as np

from ..core import solve_iccg, solve_iccg_batched
from ..core.matrices import laplace_2d
from . import device_parser

PLAN = dict(method="hbmc", block_size=16, w=8)


def main(argv=None) -> dict:
    args = device_parser(__doc__).parse_args(argv)
    # 2-D Poisson problem, 64x64 grid
    a = laplace_2d(64, 64)
    rng = np.random.default_rng(0)
    b = rng.normal(size=a.shape[0])
    out = {"n": a.shape[0], "nnz": a.nnz}

    print(f"n = {a.shape[0]}, nnz = {a.nnz}")
    for method in ("mc", "bmc", "hbmc"):
        rep = solve_iccg(a, b, method=method, block_size=16, w=8, rtol=1e-7,
                         device=args.device)
        out[method] = dict(iterations=rep.result.iterations,
                           relres=rep.result.relres, n_colors=rep.n_colors,
                           n_rounds=rep.n_rounds,
                           lane_occupancy=rep.lane_occupancy, x=rep.x)
        print(f"{method:5s}: {rep.result.iterations:4d} iterations, "
              f"relres {rep.result.relres:.2e}, "
              f"{rep.n_colors} colors, {rep.n_rounds} sequential rounds, "
              f"lane occupancy {rep.lane_occupancy*100:.1f}%")
    print("\nBMC and HBMC iterate identically (the paper's equivalence "
          "theorem); HBMC additionally exposes w-wide vector lanes per "
          "round for the GPU's threads.")

    # --- the other route: the same solve through the plain versions -------
    # (the kernels run on the card; on the CPU both routes are plain)
    rep_p = solve_iccg(a, b, device="cpu", **PLAN)
    route = "the plain versions" if args.device == "cpu" else "the kernels"
    out["plain"] = dict(iterations=rep_p.result.iterations,
                        relres=rep_p.result.relres, x=rep_p.x)
    print(f"\nplain versions (CPU): {rep_p.result.iterations} iterations, "
          f"relres {rep_p.result.relres:.2e}; {route} ({args.device}): "
          f"{out['hbmc']['iterations']} iterations")

    # --- batched multi-RHS: 4 systems through ONE PCG loop ----------------
    bb = rng.normal(size=(a.shape[0], 4))
    rep_b = solve_iccg_batched(a, bb, device=args.device, **PLAN)
    out["batched"] = dict(iterations=rep_b.result.iterations,
                          n_steps=rep_b.result.n_steps,
                          converged=bool(rep_b.result.converged.all()),
                          x=rep_b.x)
    print(f"batched B=4:    per-RHS iterations {rep_b.result.iterations} "
          f"in {rep_b.result.n_steps} loop steps "
          f"(converged: {rep_b.result.converged.all()})")
    return out


if __name__ == "__main__":
    main()
