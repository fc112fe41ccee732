"""Dispatch-stream contract linter: per-path budgets of PyTorch ops.

Port of ``repro.analysis.contracts``.  The reference walks the jaxpr of a
lowering path; the port has no jaxpr, so it runs the path once, eagerly,
under a ``TorchDispatchMode`` (:class:`OpRecorder`) that records every aten
op by name, and checks the record against a declarative
:class:`PrimitiveBudget`:

  * the round-major apply performs no scatter (``index_put_``,
    ``scatter*``, ``index_copy_``: ``ROUND_MAJOR_APPLY``);
  * an all-kernel iteration launches at least one kernel and does no
    gather or scatter outside the kernels (``FULL_PALLAS_ITERATION``),
    the SpMV likewise (``PALLAS_SPMV``);
  * the mesh apply issues exactly one all-gather per fused step, 2S per
    apply (``DISTRIBUTED_APPLY``), read from ``core.mesh.gather_counts``;
  * a preconditioned PCG iteration runs both triangular sweeps, the fused
    apply once or the two sweep kernels of the index layout
    (``PRECONDITIONED_ITERATION``);
  * ``refactor`` captures no CUDA graph (:func:`recaptures`, over
    ``SolverPlan._capture_count``, the reference's ``retraces``).

**Kernels are opaque nodes**, as the reference's ``descend_pallas=False``.
On the card a kernel's ctypes launch never reaches the dispatcher; on the
CPU the wrapper runs the kernel's plain version, whose ops would.  The
wrappers mark their bodies (``kernels/_trace.py``): a body runs outside
the recorder, which records each call as one node ``kernel.<wrapper>``,
so a path gives the same record on both devices.

**Eager calls only.**  A replayed CUDA graph dispatches nothing, and a
capture under a dispatch mode is not supported, so the linters run the
apply, the SpMV and one eager block of the PCG step function
(``dtype_flow._plan_paths``), never a captured loop.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import mesh
from ..kernels import _trace


class ContractError(AssertionError):
    """A path violated its contract.  Carries ``findings`` (one string per
    violated budget line)."""

    def __init__(self, findings: list[str], context: str = ""):
        self.findings = list(findings)
        prefix = f"{context}: " if context else ""
        super().__init__(prefix + "; ".join(self.findings))


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of a run: an aten op outside the kernels (``aten.mul``,
    ``c10d._allgather_base_``) or a kernel node (``kernel.sell_spmv``),
    with the dtypes of its tensor inputs and outputs."""
    index: int
    name: str
    inputs: tuple
    outputs: tuple


def _tensors(tree) -> list[torch.Tensor]:
    out = []
    for a in tree if isinstance(tree, (list, tuple)) else (tree,):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += _tensors(a)
    return out


class OpRecorder(TorchDispatchMode):
    """Records the ops a block of eager PyTorch code dispatches, with each
    kernel wrapper call as one node (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def _add(self, name: str, inputs, outputs) -> None:
        self.records.append(OpRecord(
            index=len(self.records), name=name,
            inputs=tuple(t.dtype for t in _tensors(inputs)),
            outputs=tuple(t.dtype for t in _tensors(outputs))))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._add(f"{func.namespace}.{func.overloadpacket.__name__}",
                  (list(args), list((kwargs or {}).values())), out)
        return out

    def _kernel(self, name: str, args: tuple, out) -> None:
        self._add(f"kernel.{name}", list(args), out)

    def __enter__(self):
        self._observe = _trace.observing(self._kernel)
        self._observe.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observe.__exit__(*exc)


def record(fn, *args) -> tuple[list[OpRecord], Counter]:
    """Run ``fn(*args)`` eagerly under an :class:`OpRecorder`; returns the
    records and the all-gathers the mesh counters saw
    (``all_gather.trisolve``, ``all_gather.spmv``)."""
    before = mesh.gather_counts()
    with OpRecorder() as rec:
        fn(*args)
    after = mesh.gather_counts()
    gathers = Counter({f"all_gather.{who}": after[who] - before[who]
                       for who in after})
    return rec.records, gathers


def primitive_counts(fn, *args) -> Counter:
    """Multiset of what ``fn(*args)`` ran: aten ops outside the kernels by
    name, kernel nodes (``kernel.<wrapper>``, and ``kernel`` for all of
    them), the mesh's all-gathers (``all_gather.<caller>`` and
    ``all_gather``)."""
    records, gathers = record(fn, *args)
    counts = Counter(r.name for r in records)
    counts["kernel"] = sum(c for n, c in counts.items()
                           if n.startswith("kernel."))
    counts.update(gathers)
    counts["all_gather"] = sum(gathers.values())
    return counts


#: triangular sweeps each trisolve kernel node runs: the fused apply both,
#: a sweep kernel one; the shard step runs one fused step (of 2S)
_SWEEPS = {"kernel.hbmc_trisolve_fused": 2,
           "kernel.hbmc_trisolve_fused_batched": 2,
           "kernel.hbmc_trisolve": 1, "kernel.hbmc_trisolve_batched": 1}
_SHARD_STEPS = ("kernel.hbmc_trisolve_shard_step",
                "kernel.hbmc_trisolve_shard_step_batched")


@dataclasses.dataclass(frozen=True)
class PrimitiveBudget:
    """Declarative contract for one path.

    ``forbid_substrings``  no op outside the kernels may contain any of
                           these in its name
    ``require``            each of these names must appear >= once
                           (``kernel``: any kernel node)
    ``exact``              ((name, count), ...): exactly ``count`` times
    ``per_step``           ((name, count), ...): exactly ``count`` times per
                           fused step of the plan (2S per apply)
    ``sweeps``             if set, the triangular sweeps the kernels ran
                           must be exactly this (a fused apply is two, a
                           sweep kernel one, 2S shard steps two)
    """
    name: str
    forbid_substrings: tuple = ()
    require: tuple = ()
    exact: tuple = ()
    per_step: tuple = ()
    sweeps: int | None = None


def lint(fn, *args, budget: PrimitiveBudget,
         steps: int | None = None) -> list[str]:
    """Evaluate ``budget`` against one eager run of ``fn(*args)``; return
    findings (empty = conforming).  ``steps`` is the plan's fused steps
    (2S), which ``per_step`` and the shard step's sweeps need."""
    counts = primitive_counts(fn, *args)
    findings = []
    for sub in budget.forbid_substrings:
        hits = sorted(p for p, c in counts.items() if c and sub in p
                      and not p.startswith(("kernel", "all_gather")))
        if hits:
            findings.append(f"[{budget.name}] forbidden op(s) {hits} "
                            f"(matched {sub!r})")
    for p in budget.require:
        if counts[p] == 0:
            findings.append(f"[{budget.name}] required {p!r} absent")
    for p, want in budget.exact:
        if counts[p] != want:
            findings.append(f"[{budget.name}] expected exactly {want} "
                            f"{p!r}, found {counts[p]}")
    if steps is None and (budget.per_step or (
            budget.sweeps is not None
            and any(counts[p] for p in _SHARD_STEPS))):
        findings.append(f"[{budget.name}] needs the plan's fused steps "
                        f"(steps=2S)")
        return findings
    for p, per in budget.per_step:
        want = per * steps
        if counts[p] != want:
            findings.append(f"[{budget.name}] expected {per} {p!r} per "
                            f"fused step, {want} for {steps} steps; found "
                            f"{counts[p]}")
    if budget.sweeps is not None:
        sweeps = sum(w * counts[p] for p, w in _SWEEPS.items())
        shard = sum(counts[p] for p in _SHARD_STEPS)
        if shard:
            sweeps += 2 * shard / steps
        if sweeps != budget.sweeps:
            findings.append(f"[{budget.name}] expected {budget.sweeps} "
                            f"triangular sweeps in the kernels, found "
                            f"{sweeps:g}")
    return findings


def assert_budget(fn, *args, budget: PrimitiveBudget,
                  steps: int | None = None, context: str = "") -> None:
    findings = lint(fn, *args, budget=budget, steps=steps)
    if findings:
        raise ContractError(findings, context=context)


# ---------------------------------------------------------------------------
# The port's path contracts (the one place they are defined).
# ---------------------------------------------------------------------------

#: the scatters of PyTorch (the index layout's permutations are
#: ``index_copy_``; a round-major apply has none)
_SCATTER = ("index_put", "scatter", "index_copy", "index_add")
#: the gathers of PyTorch (advanced indexing is ``aten.index``)
_GATHER = ("aten.index", "gather", "aten.take", "embedding")

#: Round-major apply: no scatter; its stores are the kernel's dense slices.
ROUND_MAJOR_APPLY = PrimitiveBudget(
    name="round-major-apply", forbid_substrings=_SCATTER)

#: All-kernel iteration: at least one kernel node, no gather or scatter
#: outside the kernels.
FULL_PALLAS_ITERATION = PrimitiveBudget(
    name="full-pallas-iteration", forbid_substrings=_GATHER + _SCATTER,
    require=("kernel",))

#: Kernel SpMV: a kernel node, no gather outside it.
PALLAS_SPMV = PrimitiveBudget(
    name="pallas-spmv", forbid_substrings=_GATHER, require=("kernel",))

#: Mesh apply: one all-gather per fused step (2S an apply), the port's run
#: of the reference's one all_gather in the traced loop body.
DISTRIBUTED_APPLY = PrimitiveBudget(
    name="distributed-apply", per_step=(("all_gather.trisolve", 1),))

#: Preconditioned PCG iteration: both substitution sweeps, once.
PRECONDITIONED_ITERATION = PrimitiveBudget(
    name="preconditioned-iteration", sweeps=2)


def recaptures(plan, thunk) -> int:
    """Run ``thunk`` and return how many CUDA graphs it captured for
    ``plan``'s PCG loops: the refactor contract is ``recaptures(plan,
    lambda: plan.refactor(a2)) == 0``, followed by a warm solve that
    captures none either."""
    before = plan._capture_count
    thunk()
    return plan._capture_count - before
