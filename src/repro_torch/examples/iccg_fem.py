"""The paper's end-to-end scenario: shifted ICCG on an eddy-current-style
FEM system, comparing MC / BMC / HBMC orderings and the SELL vs CRS-gather
SpMV variants (paper Tables 5.2 + 5.3); twin of ``examples/iccg_fem.py``.

    PYTHONPATH=src python -m repro_torch.examples.iccg_fem \
        [--scale tiny|small|bench] [--dataset ieej] [--device cpu]
"""
import numpy as np

from ..core import solve_iccg
from ..core.matrices import PAPER_SHIFTS, paper_problem
from . import device_parser

#: (method, SpMV format) of each row, as the reference names them
ROWS = (("mc", "ell"), ("bmc", "ell"), ("hbmc", "ell"), ("hbmc", "sell"))


def main(argv=None) -> dict:
    ap = device_parser(__doc__)
    ap.add_argument("--scale", default="small",
                    choices=("tiny", "small", "bench"))
    ap.add_argument("--dataset", default="ieej")
    args = ap.parse_args(argv)

    a, desc = paper_problem(args.dataset, scale=args.scale)
    shift = PAPER_SHIFTS.get(args.dataset, 0.0)
    b = np.random.default_rng(0).normal(size=a.shape[0])
    print(f"dataset={args.dataset} ({desc}), n={a.shape[0]}, nnz={a.nnz}, "
          f"IC shift={shift}")
    out = {"dataset": args.dataset, "n": a.shape[0], "nnz": a.nnz,
           "shift": shift, "rows": []}

    print(f"\n{'solver':22s} {'iters':>6s} {'setup(s)':>9s} "
          f"{'solve(s)':>9s} {'relres':>9s}")
    for method, fmt in ROWS:
        rep = solve_iccg(a, b, method=method, block_size=16, w=8,
                         shift=shift, rtol=1e-7, spmv_format=fmt,
                         device=args.device)
        out["rows"].append(dict(
            solver=f"{method}/{fmt}", iterations=rep.result.iterations,
            status=rep.result.status, setup_s=rep.setup_seconds,
            solve_s=rep.solve_seconds, relres=rep.result.relres, x=rep.x))
        print(f"{method+'('+fmt+'_spmv)':22s} {rep.result.iterations:6d} "
              f"{rep.setup_seconds:9.2f} {rep.solve_seconds:9.2f} "
              f"{rep.result.relres:9.2e}")
    return out


if __name__ == "__main__":
    main()
