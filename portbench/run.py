"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port under ``src/``.  The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, under
``--trace 1`` a ``breakdown``, and last the ``checks``: each number the
reference compared, beside its limit); the checks are also the last lines
of standard error.  Exit status 2 and no result line where there is no
CUDA device or fewer than the cell asks for, 3 where a module of the JAX
stack was loaded, 1 on any other failure.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib import guard, harness, spec

    chips = int(spec.cell(spec.load_benchmark(ROOT),
                          args.workload)["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda:0", T_PROCESS,
                                root=ROOT)
    except guard.ForbiddenModules as e:
        print(f"portbench: modules of the JAX stack loaded: {e}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
