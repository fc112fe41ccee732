"""The control of ``correct``, and the readings its limits are set from.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 \
        --seconds 5 [--dtype float32]

Runs the cell's set-up and window on each seed in turn, in one process,
with the configuration's plan in ``--dtype``: the program's own float32
path is the control (the configuration states float64), and the default
``float64`` gives further readings of the program itself.  Prints one JSON
line a seed with the compared numbers (``checks``) and whether they pass.
Not run by ``run.py``; a test keeps it at a size the CPU holds
(``tests/test_portbench_control.py``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib import harness, spec

    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    c = spec.cell(spec.load_benchmark(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        config = spec.load_json_path(ROOT / c["config"]["file"])
        config["plan"]["dtype"] = args.dtype
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                "cuda:0", time.perf_counter(), root=ROOT,
                                config=config)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
