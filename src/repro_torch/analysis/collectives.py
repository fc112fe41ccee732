"""Collective-structure proofs of a plan, from the mesh counters and the
dispatch stream.

Port of ``repro.analysis.collectives``.  The paper's distributed claim
(§4.4.3) is that one color round costs one synchronization: on a mesh, one
all-gather per fused sweep step and nothing else.  The reference proves it
over the optimized HLO of the shard_map lowering (``analysis/hlo.py``); the
port compiles no HLO and issues its collectives from Python, so it proves
the same structure over one eager run of each path:

  * the all-gathers that ``core.mesh`` counts (``mesh.gather_counts``, one
    per ``all_gather_`` call), and
  * the c10d ops in the dispatch stream (``contracts.OpRecorder``), where
    any collective the mesh did not count shows, all-reduces included.

The contract: a single-device plan issues no collective; a mesh apply
issues exactly 2S all-gathers (one per fused step), a mesh SpMV exactly
one, and a PCG solve (one eager block of the loop) no all-reduce,
reduce-scatter, all-to-all, broadcast or point-to-point op -- the state
vectors are replicated, so the dot products need none.  Witnesses reuse
:class:`~repro_torch.analysis.schedule.Violation`.
"""
from __future__ import annotations

from .contracts import record
from .dtype_flow import LINT_STEPS, _plan_paths
from .schedule import ScheduleError, Violation

#: collectives the solver may never issue (c10d op names contain these)
FORBIDDEN_COLLECTIVES = ("allreduce", "reduce_scatter", "alltoall",
                         "broadcast", "send", "recv")


def _census(fn, *args) -> tuple[dict, dict]:
    """(mesh all-gathers by caller, c10d ops of the dispatch stream by
    name) of one eager run of ``fn(*args)``."""
    records, gathers = record(fn, *args)
    c10d: dict = {}
    for r in records:
        if r.name.startswith("c10d."):
            c10d[r.name] = c10d.get(r.name, 0) + 1
    return {k.split(".", 1)[1]: v for k, v in gathers.items()}, c10d


def check_collectives(fn, *args, trisolve: int = 0, spmv: int = 0,
                      where: str = "collectives") -> list[Violation]:
    """Prove that one run of ``fn(*args)`` issues exactly ``trisolve``
    mesh-trisolve and ``spmv`` mesh-SpMV all-gathers, no collective that
    the mesh did not count, and no forbidden one."""
    gathers, c10d = _census(fn, *args)
    out: list[Violation] = []
    for who, want in (("trisolve", trisolve), ("spmv", spmv)):
        got = gathers.get(who, 0)
        if got != want:
            out.append(Violation(
                kind="extra-collective" if got > want
                else "missing-collective", where=where,
                detail=f"{got} {who} all-gather(s), expected exactly "
                       f"{want}"))
    forbidden = {n: c for n, c in c10d.items()
                 if any(f in n for f in FORBIDDEN_COLLECTIVES)}
    if forbidden:
        out.append(Violation(
            kind="forbidden-collective", where=where,
            detail=f"{forbidden} in the dispatch stream; only the mesh's "
                   f"all-gathers are allowed"))
    seen = sum(c for n, c in c10d.items() if "allgather" in n)
    counted = sum(gathers.values())
    if seen > counted:
        out.append(Violation(
            kind="extra-collective", where=where,
            detail=f"{seen} all-gather op(s) in the dispatch stream, "
                   f"{counted} counted by the mesh"))
    return out


def check_plan_collectives(plan) -> list[Violation]:
    """Run the plan's apply, SpMV and one eager block of its PCG loop and
    prove their collective structure: none on a single device; on a mesh
    2S all-gathers an apply, one a SpMV, and nothing forbidden in the
    solve."""
    paths = _plan_paths(plan)
    if plan.mesh is None:
        return [v for name in ("apply", "spmv", "pcg")
                for v in check_collectives(
                    paths[name][0], *paths[name][1],
                    where=f"collectives/{name}")]
    steps = 2 * plan.n_rounds
    fn, args = paths["apply"]
    out = check_collectives(fn, *args, trisolve=steps,
                            where="collectives/apply")
    fn, args = paths["spmv"]
    out += check_collectives(fn, *args, spmv=1, where="collectives/spmv")
    # the solve: the apply before the loop and one apply and one SpMV per
    # step of the block
    fn, args = paths["pcg"]
    k = LINT_STEPS
    out += check_collectives(fn, *args, trisolve=steps * (1 + k), spmv=k,
                             where="collectives/solve")
    return out


def assert_plan_collectives(plan, context: str = "") -> None:
    """``check_plan_collectives`` that raises :class:`ScheduleError`."""
    violations = check_plan_collectives(plan)
    if violations:
        raise ScheduleError(violations, context=context)
