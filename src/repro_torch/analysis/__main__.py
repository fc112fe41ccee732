"""Audit matrices / orderings / plans of the port from the command line.

    PYTHONPATH=src python -m repro_torch.analysis
        [--problems thermal2,parabolic_fem,...]   (default: all paper five)
        [--methods hbmc,bmc,mc]                   (default: hbmc,bmc,mc)
        [--schedulers coloring,levelset]          (default: coloring)
        [--scale tiny|small|bench]                (default: tiny)
        [--validate cheap|full|deep]              (default: full)
        [--contracts]        also lint the apply / iteration dispatch
                             streams against their op budgets
        [--dtype-flow]       lint dtype propagation on every path
        [--collectives]      prove the collective structure of the plan
                             (a mesh plan over the process group's ranks
                             when torch.distributed is initialized)
        [--traffic]          check the kernels' bound bytes against the
                             bytes the wrappers see  [--traffic-tol 0.10]
        [--witness-json PATH]  dump machine-readable witnesses on failure
        [--device cuda|cpu]  (default: cuda; raises without a CUDA device)

    PYTHONPATH=src python -m repro_torch.analysis bench-gate
        [--baseline-dir benchmarks] [--candidate RUN.json ...]
        [--tolerance 0.5] [--smoke] [--witness-json PATH]

Port of ``python -m repro.analysis``.  For every (problem, method) pair the
audit builds a plan on ``--device``, runs the schedule race detector at the
requested depth (segment cuts included), the static kernel checks, and any
of the opt-in linters above.  Prints one line per audit; on failure prints
every witness and exits 1.  ``laplace2d`` / ``laplace3d`` are accepted as
extra problem names beside the paper generators.  The reference's
``--backend`` / ``--spmv-backend`` are unknown here, as in ``build_plan``:
the port runs its kernels on the card and their plain versions on the CPU.

``bench-gate`` compares fresh bench runs (``--candidate``) against the
committed ``BENCH_*.json`` snapshots, matching files by their ``schema``
field; ``--smoke`` gates every committed snapshot against itself to
prove the gate covers each schema.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

from repro_torch.analysis import (FULL_PALLAS_ITERATION,
                                  PRECONDITIONED_ITERATION,
                                  ROUND_MAJOR_APPLY, Violation, bench_gate,
                                  check_plan_collectives,
                                  check_plan_dtype_flow, check_plan_kernels,
                                  check_plan_traffic, lint, validate_plan)
from repro_torch.analysis.dtype_flow import nonzero_rhs


def _matrix(name: str, scale: str):
    from repro_torch.core.matrices import laplace_2d, laplace_3d, \
        paper_problem
    if name == "laplace2d":
        g = {"tiny": 16, "small": 64, "bench": 352}[scale]
        return laplace_2d(g, g), "2-D 5-point Laplacian"
    if name == "laplace3d":
        g = {"tiny": 8, "small": 16, "bench": 46}[scale]
        return laplace_3d(g, g, g, stencil=27), "3-D 27-point Laplacian"
    return paper_problem(name, scale)


def _lint_iteration(plan) -> list:
    """One PCG iteration (``core.iccg.pcg_iteration``) against the
    all-kernel and both-sweeps budgets."""
    import torch

    from repro_torch.core.iccg import pcg_iteration
    step = pcg_iteration(plan._spmv, plan._precond)
    b = nonzero_rhs(plan)
    args = (torch.zeros_like(b), b, b.clone(),
            torch.ones((), dtype=plan.dtype, device=plan.device))
    steps = 2 * plan.n_rounds
    return (lint(step, *args, budget=FULL_PALLAS_ITERATION, steps=steps)
            + lint(step, *args, budget=PRECONDITIONED_ITERATION,
                   steps=steps))


def audit(name: str, method: str, scale: str, validate: str,
          contracts: bool, device: str, dtype_flow: bool = False,
          collectives: bool = False, traffic: bool = False,
          traffic_tol: float = 0.10, scheduler: str = "coloring") -> list:
    """Build + audit one (problem, method); returns findings.

    Findings are :class:`Violation` instances where a check produced a
    witness, plain strings otherwise (budget lint, build errors).
    """
    from repro_torch.core import build_plan
    from repro_torch.core.matrices import PAPER_SHIFTS

    a, _ = _matrix(name, scale)
    shift = PAPER_SHIFTS.get(name, 0.0)
    plan = build_plan(a, method=method, shift=shift, scheduler=scheduler,
                      device=device, validate="off")
    findings: list = list(validate_plan(plan, validate))
    findings += check_plan_kernels(plan)
    if contracts:
        findings += lint(plan._precond, nonzero_rhs(plan),
                         budget=ROUND_MAJOR_APPLY)
        findings += _lint_iteration(plan)
    if dtype_flow:
        findings += check_plan_dtype_flow(plan)
    if traffic:
        try:
            findings += check_plan_traffic(plan, tolerance=traffic_tol)
        except ValueError as e:   # non-round_major layouts have no model
            findings.append(f"traffic model unavailable: {e}")
    if collectives:
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_world_size() > 1:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(plan.device.type,
                                    (dist.get_world_size(),),
                                    mesh_dim_names=("data",))
            mplan = build_plan(a, method=method, shift=shift,
                               scheduler=scheduler, mesh=mesh,
                               validate="full")
            findings += check_plan_collectives(mplan)
        else:
            # one process: prove the local paths stay collective-free
            findings += check_plan_collectives(plan)
    return findings


def _witness_dicts(findings: list) -> list[dict]:
    return [dataclasses.asdict(f) if isinstance(f, Violation)
            else {"detail": str(f)} for f in findings]


def _write_witnesses(path: str | None, witnesses: list[dict]) -> None:
    if path:
        with open(path, "w") as fh:
            json.dump(witnesses, fh, indent=2)


def audit_main(argv: list[str] | None = None) -> int:
    from repro_torch.core.matrices import PAPER_PROBLEMS
    from repro_torch.kernels import resolve_device
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static schedule race detector + kernel contract audit")
    ap.add_argument("--problems",
                    default=",".join(PAPER_PROBLEMS),
                    help="comma-separated problem names (paper generators, "
                         "laplace2d, laplace3d)")
    ap.add_argument("--methods", default="hbmc,bmc,mc",
                    help="comma-separated orderings (hbmc,bmc,mc,natural)")
    ap.add_argument("--schedulers", default="coloring",
                    help="comma-separated round-schedule backends to audit "
                         "(coloring,levelset)")
    ap.add_argument("--scale", default="tiny",
                    choices=("tiny", "small", "bench"))
    ap.add_argument("--validate", default="full",
                    choices=("cheap", "full", "deep"))
    ap.add_argument("--contracts", action="store_true",
                    help="also lint the apply and iteration op budgets")
    ap.add_argument("--dtype-flow", action="store_true",
                    help="lint dtype propagation on every path")
    ap.add_argument("--collectives", action="store_true",
                    help="prove the collective structure (a mesh plan over "
                         "the process group when torch.distributed is "
                         "initialized)")
    ap.add_argument("--traffic", action="store_true",
                    help="check the kernels' bound bytes against the bytes "
                         "the wrappers see")
    ap.add_argument("--traffic-tol", type=float, default=0.10,
                    help="relative tolerance for --traffic (default 0.10)")
    ap.add_argument("--witness-json", default=None, metavar="PATH",
                    help="dump machine-readable witnesses to PATH")
    ap.add_argument("--device", default="cuda",
                    help="where the plans run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))   # raises without a card

    problems = [p for p in args.problems.split(",") if p]
    methods = [m for m in args.methods.split(",") if m]
    schedulers = [s for s in args.schedulers.split(",") if s]
    failures = 0
    witnesses: list[dict] = []
    for name in problems:
        for method in methods:
            for scheduler in schedulers:
                try:
                    findings = audit(name, method, args.scale,
                                     args.validate, args.contracts, device,
                                     dtype_flow=args.dtype_flow,
                                     collectives=args.collectives,
                                     traffic=args.traffic,
                                     traffic_tol=args.traffic_tol,
                                     scheduler=scheduler)
                except Exception as e:  # a build failure is an audit failure
                    findings = [f"build failed: {type(e).__name__}: {e}"]
                status = "ok" if not findings else "FAIL"
                print(f"{name:16s} {method:8s} {scheduler:9s} "
                      f"{args.validate:5s} {status}")
                for f in findings:
                    print(f"    {f}")
                witnesses += _witness_dicts(findings)
                failures += bool(findings)
    if failures:
        _write_witnesses(args.witness_json, witnesses)
        print(f"\n{failures} audit(s) failed", file=sys.stderr)
        return 1
    print(f"\nall {len(problems) * len(methods) * len(schedulers)} audits "
          f"clean (validate={args.validate}, device={device}, "
          f"schedulers={','.join(schedulers)})")
    return 0


def bench_gate_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis bench-gate",
        description="gate bench runs against committed BENCH_*.json "
                    "snapshots (matched by their 'schema' field)")
    ap.add_argument("--baseline-dir", default="benchmarks",
                    help="directory holding committed BENCH_*.json")
    ap.add_argument("--candidate", action="append", default=[],
                    metavar="RUN.json",
                    help="fresh bench output to gate (repeatable)")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="allowed relative regression (default 0.5 = 50%%, "
                         "wide because CI machines are noisy)")
    ap.add_argument("--smoke", action="store_true",
                    help="gate every committed snapshot against itself")
    ap.add_argument("--witness-json", default=None, metavar="PATH",
                    help="dump machine-readable witnesses to PATH")
    args = ap.parse_args(argv)

    baselines: dict[str, tuple[str, dict]] = {}
    for path in sorted(glob.glob(os.path.join(args.baseline_dir,
                                              "BENCH_*.json"))):
        with open(path) as fh:
            doc = json.load(fh)
        schema = doc.get("schema", os.path.basename(path))
        baselines[schema] = (path, doc)
    if not baselines:
        print(f"no BENCH_*.json under {args.baseline_dir}", file=sys.stderr)
        return 1

    comparisons: list[tuple[str, dict, dict]] = []
    if args.smoke:
        for schema, (path, doc) in baselines.items():
            comparisons.append((f"{schema} (self)", doc, doc))
    for cpath in args.candidate:
        with open(cpath) as fh:
            cand = json.load(fh)
        schema = cand.get("schema")
        if schema not in baselines:
            known = ", ".join(sorted(baselines))
            print(f"{cpath}: no baseline with schema {schema!r} "
                  f"(known: {known})", file=sys.stderr)
            return 1
        bpath, base = baselines[schema]
        comparisons.append((f"{schema} ({cpath} vs {bpath})", base, cand))
    if not comparisons:
        ap.error("nothing to gate: pass --candidate and/or --smoke")

    failures = 0
    witnesses: list[dict] = []
    for label, base, cand in comparisons:
        found = bench_gate(base, cand, tolerance=args.tolerance,
                           where=f"bench-gate:{base.get('schema')}")
        status = "ok" if not found else "FAIL"
        print(f"{label:60s} {status}")
        for v in found:
            print(f"    {v}")
        witnesses += _witness_dicts(found)
        failures += bool(found)
    if failures:
        _write_witnesses(args.witness_json, witnesses)
        print(f"\n{failures} gate(s) failed", file=sys.stderr)
        return 1
    print(f"\nall {len(comparisons)} gate(s) passed "
          f"(tolerance={args.tolerance:g})")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "bench-gate":
        return bench_gate_main(argv[1:])
    return audit_main(argv)


if __name__ == "__main__":
    sys.exit(main())
