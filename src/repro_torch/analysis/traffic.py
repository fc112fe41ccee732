"""Static traffic model, the kernels' bound bytes, the bench regression gate.

Port of ``repro.analysis.traffic``.  Li (arXiv:1710.04985) argues the
end-to-end ICCG win is decided by bytes-per-iteration; this module makes
that quantity a *checked* number instead of a believed one.

**Static model** (the reference's, term for term).  Every byte the hot loop
moves is determined by the plan's packed table shapes: the fused 2S-step
sweep streams its per-step table slices (cols/vals/dinv) plus four
R-vectors of state per step, the SpMV gathers one x value per packed slot,
and the PCG vector work streams a fixed number of m-vectors per iteration.
:func:`traffic_report` computes those terms, the per-iteration FLOPs and the
arithmetic intensity; on the same plan they equal the reference's
``traffic_report(plan, measure=False)``.

**Kernel terms and their measurement.**  The reference cross-checks its
model against the slice bytes of the compiled HLO (``analysis/hlo.py``).
The port compiles no HLO; its counterpart is what the kernel wrappers were
handed.  Every wrapper call adds its operands' bytes to
``kernels.operand_bytes`` (``kernels/_trace.py``), and
:func:`traffic_report` runs one apply and one SpMV of the plan and reads
them back as the measured side of two more terms, ``kernel/apply`` and
``kernel/spmv``, whose static side is :func:`trisolve_bytes` /
:func:`spmv_bytes` of the plan's operands: each input read once, each
output written once, the bytes of a kernel's bound (:func:`bound`, which
``chip_smoke.py`` reports for every kernel).  :func:`check_plan_traffic`
fails with a ``Violation`` naming the term when the two drift apart beyond
tolerance: a table padded larger than the plan's on its way to the kernel,
or an apply that launches twice.

**Bench gate.**  :func:`bench_gate` compares two benchmark snapshots
(committed ``benchmarks/BENCH_*.json`` against a fresh run) metric by
metric: time-like metrics may not regress beyond tolerance, throughput-like
metrics may not drop, iteration counts may not grow.  It only reads the
snapshots; ``python -m repro_torch.analysis bench-gate`` runs it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .schedule import ScheduleError, Violation

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: vector (non-tensor-core) rates of the element types the kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.float64": 34e12, "torch.float32": 67e12}


def trisolve_bytes(tables, q) -> int:
    """Bytes of one trisolve call (B1/B3 on a fused table, B5/B6 on a
    sweep): each input read once, the (S*R[, B]) output written once."""
    return (tables.cols.numel() * tables.cols.element_size()
            + tables.vals.numel() * tables.vals.element_size()
            + tables.dinv.numel() * tables.dinv.element_size()
            + 2 * q.numel() * q.element_size())


def spmv_bytes(vals, cols, x) -> int:
    """Bytes of one SELL SpMV call: vals, cols and x (n[, B]) read once, y
    (n_rows[, B]) written once."""
    n_rows = vals.shape[0] * vals.shape[2]
    n_cols = x.numel() // x.shape[0]
    return (vals.numel() * vals.element_size()
            + cols.numel() * cols.element_size()
            + x.numel() * x.element_size()
            + n_rows * n_cols * x.element_size())


def bound(n_bytes: int, n_ops: int, dtype) -> tuple[float, str]:
    """The least time (ms) a call of ``n_bytes`` and ``n_ops`` operations
    of ``dtype`` can take on the card, and what bounds it: the larger of
    bytes over the memory rate and operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass(frozen=True)
class TrafficTerm:
    """One byte stream of the hot loop.  ``measured_bytes`` is filled where
    the port measures the term (the kernel terms; None = static-only)."""
    name: str
    static_bytes: float
    measured_bytes: float | None = None
    detail: str = ""

    @property
    def relative_error(self) -> float | None:
        if self.measured_bytes is None or self.measured_bytes == 0:
            return None
        return abs(self.static_bytes - self.measured_bytes) \
            / self.measured_bytes


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """Per-iteration data movement of one plan, term by term.  ``terms``
    are the reference's model (their sum is ``iteration_bytes``);
    ``kernel_terms`` the bound bytes of one apply and one SpMV, measured
    through the wrappers."""
    label: str
    terms: tuple
    iteration_bytes: float      # static bytes per PCG iteration
    iteration_flops: float      # static FLOPs per PCG iteration
    kernel_terms: tuple = ()

    @property
    def arithmetic_intensity(self) -> float:
        return self.iteration_flops / self.iteration_bytes \
            if self.iteration_bytes else 0.0


#: m-vector streams per PCG iteration outside apply/SpMV: two dot
#: pairings (4), three axpy-likes (9), one residual norm (1)
VECTOR_STREAMS_PER_ITERATION = 14


def _whole(plan) -> tuple[tuple, int]:
    """(2S, R, K) of the whole fused tables and the packed SpMV slots: a
    mesh rank holds a block of each, the reference's arrays are global."""
    from ..core.mesh import axis_group
    s2, r, k = (int(x) for x in plan._precond.tables.cols.shape)
    slots = int(np.prod(plan._spmv_vals.shape))
    if plan.mesh is not None:
        size = axis_group(plan.mesh, plan.mesh_axis)[1]
        r, slots = r * size, slots * size
    return (s2, r, k), slots


def _apply_static_bytes(plan) -> tuple[float, str]:
    """Sliced bytes of one fused-sweep apply, from the table shapes.

    Per fused step the sweep slices: cols (R*K int32) + vals (R*K item) +
    dinv (R item) + the q read, y-destination read, y gather (R*K item)
    and the y update write.
    """
    (s2, r, k), _ = _whole(plan)
    item = plan._np_dtype.itemsize
    cidx = plan._precond.tables.cols.element_size()
    per_step = r * k * (cidx + 2 * item) + 4 * r * item
    return float(s2 * per_step), \
        f"2S={s2} steps x (R={r}, K={k}, {item}B items)"


def _spmv_gather_bytes(plan) -> tuple[float, str]:
    """The x[cols] gather of the packed SpMV: one item per packed slot."""
    _, slots = _whole(plan)
    item = plan._np_dtype.itemsize
    return float(slots * item), \
        f"{slots} packed slots x {item}B ({plan.spmv_format})"


def _kernel_terms(plan) -> tuple:
    """``kernel/apply`` and ``kernel/spmv``: the bound bytes of one apply
    and one SELL SpMV of a single-device plan, beside the operand bytes
    the wrappers saw when the plan ran one of each on its device."""
    import torch

    from .. import kernels
    t = plan._precond.tables
    q = torch.zeros((t.n_steps, t.lanes), dtype=plan.dtype,
                    device=plan.device)
    before = sum(kernels.operand_bytes().values())
    plan._precond(q.reshape(-1))
    seen_apply = sum(kernels.operand_bytes().values()) - before
    terms = [TrafficTerm("kernel/apply", float(trisolve_bytes(t, q)),
                         float(seen_apply),
                         "fused tables + q read once, y written once")]
    if plan.spmv_format == "sell":
        x = torch.zeros((plan.slab_m,), dtype=plan.dtype, device=plan.device)
        before = sum(kernels.operand_bytes().values())
        plan._spmv(x)
        seen_spmv = sum(kernels.operand_bytes().values()) - before
        terms.append(TrafficTerm(
            "kernel/spmv", float(spmv_bytes(plan._spmv_vals,
                                             plan._spmv_cols, x)),
            float(seen_spmv), "vals + cols + x read once, y written once"))
    return tuple(terms)


def traffic_report(plan, measure: bool = True) -> TrafficReport:
    """Static per-iteration traffic of a plan; with ``measure`` also the
    kernel terms, measured through one apply and one SpMV of a
    single-device plan (a mesh plan's report is static-only)."""
    if plan.layout != "round_major":
        raise ValueError("traffic model requires layout='round_major' "
                         "(the native PCG layout); index-layout plans "
                         "have no fused-sweep stream to model")
    item = plan._np_dtype.itemsize
    m = plan.slab_m
    (s2, r, k), slots = _whole(plan)

    apply_static, apply_detail = _apply_static_bytes(plan)
    gather_static, gather_detail = _spmv_gather_bytes(plan)
    # x random reads are the gather term; the streamed remainder is the
    # vals/cols parameters and the y result write
    spmv_stream = float(slots * (item + plan._spmv_cols.element_size())
                        + m * item)
    vector_stream = float(VECTOR_STREAMS_PER_ITERATION * m * item)
    terms = (
        TrafficTerm("apply", apply_static, None, apply_detail),
        TrafficTerm("spmv/gather", gather_static, None, gather_detail),
        TrafficTerm("spmv/stream", spmv_stream, None,
                    "vals + cols parameter streams + y write"),
        TrafficTerm("vector", vector_stream, None,
                    f"{VECTOR_STREAMS_PER_ITERATION} m-vector streams"),
    )
    # FLOPs: 2 MACs per packed slot (SpMV), 2 per table slot + diag scale
    # (sweep), ~10 per row of vector work
    flops = float(2 * slots + 2 * s2 * r * k + s2 * r + 10 * m)
    total = float(sum(x.static_bytes for x in terms))
    kernel_terms = _kernel_terms(plan) if measure and plan.mesh is None \
        else ()
    return TrafficReport(
        label=f"{plan.layout}/{plan.kernel_backend}/{plan.spmv_format}",
        terms=terms, iteration_bytes=total, iteration_flops=flops,
        kernel_terms=kernel_terms)


def compare_traffic(terms, tolerance: float = 0.10,
                    where: str = "traffic") -> list[Violation]:
    """Static-vs-measured witnesses for every measured term."""
    out = []
    for term in terms:
        rel = term.relative_error
        if rel is not None and rel > tolerance:
            out.append(Violation(
                kind="traffic-model-mismatch", where=where,
                detail=f"term {term.name}: static "
                       f"{term.static_bytes:.0f} B vs measured "
                       f"{term.measured_bytes:.0f} B "
                       f"({100 * rel:.1f}% > {100 * tolerance:.0f}% "
                       f"tolerance; {term.detail})"))
    return out


def check_plan_traffic(plan, tolerance: float = 0.10) -> list[Violation]:
    """Run one apply and one SpMV of the plan and prove that the bytes the
    kernel wrappers were handed match the kernel terms within
    ``tolerance``."""
    report = traffic_report(plan, measure=True)
    return compare_traffic(report.terms + report.kernel_terms, tolerance)


def assert_plan_traffic(plan, tolerance: float = 0.10,
                        context: str = "") -> None:
    violations = check_plan_traffic(plan, tolerance)
    if violations:
        raise ScheduleError(violations, context=context)


# ---------------------------------------------------------------------------
# Bench regression gate over committed BENCH_*.json snapshots.
# ---------------------------------------------------------------------------

#: record fields that identify a list entry (used as the metric path
#: segment so records match structurally, not positionally)
_ID_KEYS = ("problem", "layout", "backend", "spmv_backend", "method",
            "scheduler", "stage", "component", "name", "kind", "B",
            "slab_width", "width", "devices", "n")
_LOWER_SUFFIX = ("_us", "_ms", "_s", "_seconds")
_LOWER_SUBSTR = ("latency", "time", "p50", "p90", "p99")
_HIGHER_SUBSTR = ("per_s", "per_sec", "throughput", "speedup", "hit_rate")
#: iteration-count slack: counts are near-deterministic, but smoke-scale
#: reruns may wiggle by an iteration
_ITER_SLACK = 1.05


def _flatten_metrics(node, prefix: str = "", out: dict | None = None
                     ) -> dict:
    if out is None:
        out = {}
    if isinstance(node, dict):
        for k in sorted(node):
            key = f"{prefix}.{k}" if prefix else str(k)
            _flatten_metrics(node[k], key, out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            seg = f"[{i}]"
            if isinstance(v, dict):
                ids = [f"{k}={v[k]}" for k in _ID_KEYS
                       if isinstance(v.get(k), (str, int, float))]
                if ids:
                    seg = "[" + ",".join(ids) + "]"
            _flatten_metrics(v, prefix + seg, out)
    elif isinstance(node, bool):
        pass
    elif isinstance(node, (int, float)):
        out[prefix] = float(node)
    return out


def _direction(path: str) -> str | None:
    leaf = path.rsplit(".", 1)[-1].rsplit("]", 1)[-1].lstrip(".")
    if leaf in ("iterations", "iters") or leaf.endswith("_iterations"):
        return "iters"
    # higher-is-better first: "rhs_per_s" must not match the _s suffix
    if any(s in leaf for s in _HIGHER_SUBSTR):
        return "higher"
    if leaf in ("us", "s", "ms") \
            or any(leaf.endswith(s) for s in _LOWER_SUFFIX) \
            or any(s in leaf for s in _LOWER_SUBSTR):
        return "lower"
    return None


def bench_gate(baseline: dict, candidate: dict, tolerance: float = 0.5,
               where: str = "bench-gate") -> list[Violation]:
    """Gate ``candidate`` bench results against a ``baseline`` snapshot.

    Every gateable baseline metric must exist in the candidate (schema
    drift is a failure, not a silent skip) and stay within tolerance in
    its metric's good direction: time-like ``<= base * (1 + tol)``,
    throughput-like ``>= base / (1 + tol)``, iteration counts may not
    grow beyond a fixed 5% determinism slack.  Returns witnesses naming
    the exact metric path; empty = gate passed.
    """
    base = _flatten_metrics(baseline)
    cand = _flatten_metrics(candidate)
    out: list[Violation] = []
    gated = 0
    for path, bv in base.items():
        d = _direction(path)
        if d is None:
            continue
        if path not in cand:
            out.append(Violation(
                kind="missing-metric", where=where,
                detail=f"{path}: present in baseline, absent in "
                       f"candidate (schema drift?)"))
            continue
        cv = cand[path]
        gated += 1
        if d == "iters":
            if cv > bv * _ITER_SLACK + 0.5:
                out.append(Violation(
                    kind="iteration-regression", where=where,
                    detail=f"{path}: {cv:g} iterations vs baseline "
                           f"{bv:g} — convergence regressed"))
        elif bv <= 0:
            continue            # zero baselines carry no gateable ratio
        elif d == "lower" and cv > bv * (1.0 + tolerance):
            out.append(Violation(
                kind="perf-regression", where=where,
                detail=f"{path}: {cv:.4g} vs baseline {bv:.4g} "
                       f"(+{100 * (cv / bv - 1):.0f}% > "
                       f"{100 * tolerance:.0f}% tolerance)"))
        elif d == "higher" and cv < bv / (1.0 + tolerance):
            out.append(Violation(
                kind="perf-regression", where=where,
                detail=f"{path}: {cv:.4g} vs baseline {bv:.4g} "
                       f"(-{100 * (1 - cv / bv):.0f}% > "
                       f"{100 * tolerance:.0f}% tolerance)"))
    if gated == 0 and not out:
        out.append(Violation(
            kind="no-metrics", where=where,
            detail="baseline snapshot exposes no gateable metrics — the "
                   "gate would pass vacuously"))
    return out
