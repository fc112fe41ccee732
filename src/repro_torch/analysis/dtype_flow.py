"""Dtype-flow linter over the dispatch stream: a plan's precision contract.

Port of ``repro.analysis.dtype_flow``.  Mixed-precision preconditioning
(f32 tables inside an f64-accumulated PCG) is only safe to attempt if the
current dtype flow is provable: every path must move exactly the dtypes the
plan promised, with no silent float-to-float promotion or demotion and
every reduction accumulating in the pinned dtype.  The reference walks the
jaxpr of each lowering path; the port runs each path once, eagerly, under
``contracts.OpRecorder`` (kernels as opaque nodes) and checks every op it
recorded against a :class:`PrecisionContract`:

  * a ``_to_copy`` (``.to``) or ``copy_`` between two different float
    dtypes is a silent promotion / demotion unless the contract allowlists
    the pair;
  * a reduction (``sum``, ``dot``, ``vdot``, ``linalg_vector_norm``, ...)
    whose float output is not the contract's accumulation dtype is an
    ``accum-dtype`` witness;
  * any other float tensor of a dtype outside the contract, such as a
    ``torch.tensor(1.0)`` made in float32 inside a float64 plan, is a
    ``stray-dtype`` witness; a kernel node's operands count too.

Python scalars never become tensors of their own in these ops (``x * 2.0``
keeps ``x``'s dtype): they are the counterpart of JAX's weak types, and
pass.  Violations reuse :class:`~repro_torch.analysis.schedule.Violation`;
``detail`` names the op by its place in the run (``op #12
aten._to_copy``).  ``validate="deep"`` runs :func:`check_plan_dtype_flow`
at setup and admission; ``python -m repro_torch.analysis --dtype-flow`` from
the CLI.
"""
from __future__ import annotations

import dataclasses

import torch

from .contracts import record
from .schedule import MAX_VIOLATIONS, ScheduleError, Violation

#: reductions whose float output must be in the accumulation dtype
REDUCE_OPS = ("aten.sum", "aten.prod", "aten.cumsum", "aten.cumprod",
              "aten.dot", "aten.vdot", "aten.mv", "aten.mm", "aten.matmul",
              "aten.linalg_vector_norm", "aten.norm", "aten.mean")
#: ops that convert between dtypes
CONVERT_OPS = ("aten._to_copy", "aten.copy_", "aten._copy_from")


@dataclasses.dataclass(frozen=True)
class PrecisionContract:
    """The dtype promise of one plan configuration.

    ``vector``   dtype of the PCG state vectors (x, r, p, z, b)
    ``accum``    dtype every dot/reduction must accumulate in
    ``tables``   dtype of the packed operands (trisolve tables, SELL/ELL
                 values)
    ``allowed_converts``  extra ``(src, dst)`` float-to-float converts the
                 contract permits (a future mixed-precision plan
                 allowlists its table down-cast here)
    """
    name: str
    vector: str
    accum: str
    tables: str
    allowed_converts: tuple = ()

    @property
    def float_dtypes(self) -> frozenset:
        return frozenset((self.vector, self.accum, self.tables))


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def contract_for_plan(plan) -> PrecisionContract:
    """The contract a plan's knobs promise: today every plan is uniform
    (tables and vectors share ``plan.dtype``, accumulation included)."""
    d = _name(plan.dtype)
    return PrecisionContract(name=f"uniform-{d}", vector=d, accum=d,
                             tables=d)


def lint_dtype_flow(fn, *args, contract: PrecisionContract,
                    where: str = "dtype_flow") -> list[Violation]:
    """Run ``fn(*args)`` once and check every op it dispatched against
    ``contract``.  Returns witnesses (empty = proven clean)."""
    records, _ = record(fn, *args)
    out: list[Violation] = []
    allowed = contract.float_dtypes
    converts = tuple(map(tuple, contract.allowed_converts))
    for rec in records:
        if len(out) >= MAX_VIOLATIONS:
            break
        loc = f"op #{rec.index} {rec.name}"
        floats_in = [d for d in rec.inputs if d.is_floating_point]
        floats_out = [d for d in rec.outputs if d.is_floating_point]
        if rec.name in CONVERT_OPS and floats_in and floats_out:
            # _to_copy(src) -> out; copy_(dst, src) -> dst
            src = floats_in[-1]
            dst = floats_out[0]
            if src != dst and (_name(src), _name(dst)) not in converts:
                shrink = dst.itemsize < src.itemsize
                out.append(Violation(
                    kind="silent-demotion" if shrink else "silent-promotion",
                    where=where,
                    detail=f"{loc}: {_name(src)} -> {_name(dst)} convert "
                           f"outside contract {contract.name}"))
            continue
        if rec.name in REDUCE_OPS and floats_out \
                and _name(floats_out[0]) != contract.accum:
            out.append(Violation(
                kind="accum-dtype", where=where,
                detail=f"{loc} accumulates in {_name(floats_out[0])}, "
                       f"contract pins {contract.accum}"))
            continue
        stray = sorted({_name(d) for d in floats_in + floats_out}
                       - allowed)
        if stray:
            out.append(Violation(
                kind="stray-dtype", where=where,
                detail=f"{loc} touches {stray}, contract {contract.name} "
                       f"allows only {sorted(allowed)}"))
    return out


# ---------------------------------------------------------------------------
# Plan-level composition: every path the plan dispatches, run eagerly.
# ---------------------------------------------------------------------------

#: the PCG paths run one eager block of this many steps
LINT_STEPS = 2


def nonzero_rhs(plan, *cols: int) -> torch.Tensor:
    """A nonzero right-hand side in the solve layout (a zero one would stop
    the loops before their first step)."""
    g = torch.Generator().manual_seed(0)
    v = torch.rand((plan.slab_m,) + cols, generator=g, dtype=torch.float64)
    return (v + 0.5).to(device=plan.device, dtype=plan.dtype)


def _plan_paths(plan) -> dict:
    """name -> (fn, args) for every path of this plan, each run once
    eagerly: the apply and the SpMV (one RHS and two), one block of
    ``LINT_STEPS`` steps of each PCG loop (single, batched, slab), with no
    loop cache, so nothing is captured (``rtol`` 1e-30: the block runs
    whatever the data).  The operands' lazily computed segments are
    computed first, so no path pays for them."""
    from ..core.iccg import _pcg_batched_device, _pcg_device, \
        _pcg_slab_device
    if plan.mesh is None:       # the mesh apply launches per step
        for t in plan._step_tables():
            t.segments  # noqa: B018 -- computed once, outside the lint
    pre = plan._precond
    k = LINT_STEPS
    loop = dict(rtol=1e-30, maxiter=k, steps_per_read=k, loops=None,
                eager=True)
    r2 = nonzero_rhs(plan, 2)

    def slab():
        state = plan.new_slab_state(2)
        state.r.copy_(r2)
        return _pcg_slab_device(plan._spmv_batched, pre.apply_batched, state,
                                rtol=1e-30, maxiter=k, quantum=k,
                                steps_per_read=k, loops=None, eager=True)

    return {
        "apply": (pre, (nonzero_rhs(plan),)),
        "apply_batched": (pre.apply_batched, (nonzero_rhs(plan, 2),)),
        "spmv": (plan._spmv, (nonzero_rhs(plan),)),
        "spmv_batched": (plan._spmv_batched, (nonzero_rhs(plan, 2),)),
        "pcg": (lambda b: _pcg_device(plan._spmv, pre, b, **loop),
                (nonzero_rhs(plan),)),
        "pcg_batched": (lambda b: _pcg_batched_device(
            plan._spmv_batched, pre.apply_batched, b, **loop),
            (nonzero_rhs(plan, 2),)),
        "slab": (slab, ()),
    }


def check_plan_dtype_flow(plan, contract: PrecisionContract | None = None,
                          paths: tuple | None = None) -> list[Violation]:
    """Lint every path of a built plan against its precision contract.
    ``paths`` restricts to a subset of path names (default: all of
    apply/spmv/pcg/slab, single and batched)."""
    contract = contract or contract_for_plan(plan)
    out: list[Violation] = []
    for name, (fn, args) in _plan_paths(plan).items():
        if paths is not None and name not in paths:
            continue
        out += lint_dtype_flow(fn, *args, contract=contract,
                               where=f"dtype_flow/{name}")
        if len(out) >= MAX_VIOLATIONS:
            break
    return out


def assert_plan_dtype_flow(plan,
                           contract: PrecisionContract | None = None,
                           context: str = "") -> None:
    """``check_plan_dtype_flow`` that raises :class:`ScheduleError`."""
    violations = check_plan_dtype_flow(plan, contract)
    if violations:
        raise ScheduleError(violations, context=context)
