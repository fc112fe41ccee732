"""Static checks of the operands and launches of the port's CUDA kernels.

Port of ``repro.analysis.kernel_checks``, re-derived for the kernels in
``kernels/csrc/``.  Each check proves on the host, before a launch, what
the kernel assumes of its operands and would otherwise get wrong without an
error (an out-of-range gather reads 0 by the port's gather rule, a
truncated ``int`` addresses the wrong entry):

  * **shape and dtype** (the reference's kinds): ``shape-mismatch``,
    ``grid-divisibility`` (a fused table has 2S steps), ``index-dtype``
    (the kernels read int32 positions), ``operand-dtype`` (float32 or
    float64, one dtype for the tables);
  * **index bounds** (``index-bounds``, the reference's rule): a trisolve
    position outside ``[0, m]`` (``m = S*R``, the hole) or a live value on
    the hole, a SELL column outside ``[0, n_pad)`` with a live value.  On
    the card an index in ``[-m, 0)`` would wrap to another entry and one
    outside ``[-m, m)`` reads 0, so each is a silently wrong or dropped
    term (ROADMAP "Common semantics");
  * **int32 and int ranges** (``int32-range``, ``int-range``): the gather
    positions are int32, so ``S*R`` (and the SELL ``n_pad``) must fit in
    int32, and the step, lane, column and entry counts in the C ``int``
    arguments of the launch entry points;
  * **grids** (``grid``): each launch is a 1-D grid of ``ceil(threads
    needed / threads a block)`` blocks, which must fit ``gridDim.x``;
  * **contiguity** (``non-contiguous``): the kernels index raw pointers.

The reference also sized the TPU VMEM working set of a grid step against a
budget (``trisolve_fused_vmem_bytes``, ``sell_spmv_vmem_bytes``,
``VMEM_BUDGET_BYTES``).  The port's kernels use no shared memory: a thread
runs one lane (B1, B5), one (lane, column) (B3, B6, the shard step) or one
row (B2) or (row, 16 bytes of columns) (B4) out of registers, and their
register counts are fixed at compile time (``nvcc -Xptxas -v``, printed by
``chip_smoke.py``).  There is no per-launch working set to budget, so in
place of the budget ``plan_launches`` reports each launch's threads a block,
blocks and launches per call, and ``check_plan_kernels`` checks that every
such grid fits.  Nothing is dropped: every kernel of the plan's path is
checked and reported.

Witnesses are :class:`~repro_torch.analysis.schedule.Violation` lists
(empty = clean), so the CLI prints one format for schedule and kernel
findings alike.
"""
from __future__ import annotations

import numpy as np

from .schedule import MAX_VIOLATIONS, ScheduleError, Violation, _host

INT32_MAX = 2**31 - 1
GRID_X_MAX = 2**31 - 1      # gridDim.x of a 1-D grid
#: threads a block, as the launch code in kernels/csrc sets them
SINGLE_THREADS = 128        # B1, B5: one lane a thread
BATCHED_THREADS = 256       # B3, B6, the shard step: one (lane, column)
SPMV_THREADS = 256          # B2: one row a thread


def _contiguous(a) -> bool:
    if hasattr(a, "is_contiguous"):
        return bool(a.is_contiguous())
    return bool(np.asarray(a).flags.c_contiguous)


def _dtype_name(a) -> str:
    """The element type of a numpy array or a tensor, as numpy names it."""
    return str(a.dtype).removeprefix("torch.")


def _operand_checks(names: dict, where: str) -> list[Violation]:
    """``non-contiguous`` and ``operand-dtype`` of the named operands
    (every float operand one dtype, float32 or float64)."""
    out = [Violation(kind="non-contiguous", where=where,
                     detail=f"{name} is not contiguous; the kernel indexes "
                            f"its raw pointer")
           for name, a in names.items() if not _contiguous(a)]
    floats = {name: _dtype_name(a) for name, a in names.items()
              if name != "cols"}
    kinds = set(floats.values())
    if len(kinds) > 1 or not kinds <= {"float32", "float64"}:
        out.append(Violation(
            kind="operand-dtype", where=where,
            detail=f"operand dtypes {floats}; the kernels take one of "
                   f"float32 / float64"))
    return out


def _int_args(where: str, **args) -> list[Violation]:
    """``int-range`` for launch arguments the entry points take as C
    ``int``."""
    return [Violation(kind="int-range", where=where,
                      detail=f"{name} = {v} does not fit the kernel's int "
                             f"argument")
            for name, v in args.items() if not 0 <= v <= INT32_MAX]


def _grid(blocks: int, threads: int, where: str) -> list[Violation]:
    if blocks > GRID_X_MAX:
        return [Violation(kind="grid", where=where,
                          detail=f"{blocks} blocks of {threads} threads "
                                 f"exceed gridDim.x ({GRID_X_MAX})")]
    return []


def _blocks(n_threads: int, threads: int) -> int:
    return -(-n_threads // threads)


def _table_checks(cols, vals, dinv, fused: bool, batch: int, where: str,
                  m: int | None = None) -> list[Violation]:
    """The checks of one trisolve table (fused or one sweep, or a lane
    block of a fused table when ``m``, the whole state's size, is given)."""
    out = _operand_checks({"cols": cols, "vals": vals, "dinv": dinv}, where)
    if len(cols.shape) != 3 or tuple(cols.shape) != tuple(vals.shape):
        out.append(Violation(
            kind="shape-mismatch", where=where,
            detail=f"cols {tuple(cols.shape)} vs vals {tuple(vals.shape)}; "
                   f"expected matching (G, R, K)"))
        return out
    g_, r_, k_ = (int(x) for x in cols.shape)
    if tuple(dinv.shape) != (g_, r_):
        out.append(Violation(
            kind="shape-mismatch", where=where,
            detail=f"dinv {tuple(dinv.shape)} != {(g_, r_)}"))
        return out
    if fused and g_ % 2:
        # the fwd/bwd halves are mirrored: an odd step count cannot split
        # into two sweeps
        out.append(Violation(
            kind="grid-divisibility", where=where,
            detail=f"fused step axis {g_} is odd; expected 2*S"))
        return out
    idx_dtype = _dtype_name(cols)
    if idx_dtype != "int32":
        out.append(Violation(
            kind="index-dtype", where=where,
            detail=f"cols dtype {idx_dtype} is not int32, the positions "
                   f"the kernels read"))
        return out
    s_ = g_ // 2 if fused else g_
    m = s_ * r_ if m is None else m
    out += _int_args(where, steps=g_, lanes=r_, K=k_, B=batch)
    if m > INT32_MAX:
        # the positions cannot address the state: their bounds are moot
        out.append(Violation(
            kind="int32-range", where=where,
            detail=f"the state's {m} positions (and the hole {m}) do not "
                   f"fit the int32 gather positions"))
        return out
    c, v = _host(cols), _host(vals)
    oob = (c < 0) | (c > m)
    if oob.any():
        g, t, k = (int(x) for x in np.argwhere(oob)[0])
        out.append(Violation(
            kind="index-bounds", where=where, round=g,
            detail=f"cols[{g},{t},{k}] = {int(c[g, t, k])} outside the "
                   f"kernel's gather domain [0, {m}] (the hole is exactly "
                   f"{m}; on the card [-{m}, 0) wraps to another entry)"))
    live_hole = (c == m) & (v != 0)
    if live_hole.any():
        g, t, k = (int(x) for x in np.argwhere(live_hole)[0])
        out.append(Violation(
            kind="index-bounds", where=where, round=g,
            detail=f"vals[{g},{t},{k}] != 0 on the hole position -- the "
                   f"masked read would drop a real contribution"))
    return out


def check_trisolve_fused(cols, vals, dinv, batch: int = 1,
                         where: str = "kernel/hbmc_trisolve_fused"
                         ) -> list[Violation]:
    """Static checks of the fused table that B1 (``batch`` 1) or B3
    (``hbmc_trisolve_fused_batched``) launch."""
    out = _table_checks(cols, vals, dinv, True, batch, where)
    if len(cols.shape) == 3:
        out += _trisolve_grid(int(cols.shape[1]), batch, where)
    return out[:MAX_VIOLATIONS]


def check_trisolve_sweep(cols, vals, dinv, batch: int = 1,
                         where: str = "kernel/hbmc_trisolve"
                         ) -> list[Violation]:
    """Static checks of one sweep table that B5 (``batch`` 1) or B6
    (``hbmc_trisolve_batched``) launch: positions in ``[0, S*R]``."""
    out = _table_checks(cols, vals, dinv, False, batch, where)
    if len(cols.shape) == 3:
        out += _trisolve_grid(int(cols.shape[1]), batch, where)
    return out[:MAX_VIOLATIONS]


def check_shard_step(cols, vals, dinv, r_full: int, lane0: int,
                     batch: int = 1,
                     where: str = "kernel/hbmc_trisolve_shard_step"
                     ) -> list[Violation]:
    """Static checks of a mesh rank's lane block ``[lane0, lane0 + r_loc)``
    of a fused table of ``r_full`` lanes, as the shard step launches it:
    positions address the whole state of ``S * r_full`` entries."""
    out: list[Violation] = []
    if len(cols.shape) == 3:
        s2, r_loc = int(cols.shape[0]), int(cols.shape[1])
        if lane0 < 0 or lane0 + r_loc > r_full:
            out.append(Violation(
                kind="shape-mismatch", where=where,
                detail=f"lanes [{lane0}, {lane0 + r_loc}) are not inside "
                       f"the {r_full} lanes of the state"))
        out += _int_args(where, r_full=r_full, lane0=max(lane0, 0))
        out += _table_checks(cols, vals, dinv, True, batch, where,
                             m=(s2 // 2) * r_full)
        blocks = _blocks(r_loc * batch, BATCHED_THREADS)
        out += _grid(blocks, BATCHED_THREADS, where)
    else:
        out += _table_checks(cols, vals, dinv, True, batch, where)
    return out[:MAX_VIOLATIONS]


def _trisolve_grid(r_: int, batch: int, where: str) -> list[Violation]:
    threads = SINGLE_THREADS if batch == 1 else BATCHED_THREADS
    return _grid(_blocks(r_ * batch, threads), threads, where)


def check_sell_spmv(vals, cols, n_pad: int, batch: int = 1,
                    where: str = "kernel/sell_spmv") -> list[Violation]:
    """Static checks of a SELL-w operand as B2 (``batch`` 1) or B4
    (``sell_spmv_batched``) launch it; ``n_pad`` is the length of x."""
    out = _operand_checks({"cols": cols, "vals": vals}, where)
    if len(vals.shape) != 3 or tuple(cols.shape) != tuple(vals.shape):
        out.append(Violation(
            kind="shape-mismatch", where=where,
            detail=f"cols {tuple(cols.shape)} vs vals {tuple(vals.shape)}; "
                   f"expected matching (n_slices, K, w)"))
        return out
    n_slices, k_, w_ = (int(x) for x in vals.shape)
    idx_dtype = _dtype_name(cols)
    if idx_dtype != "int32":
        out.append(Violation(
            kind="index-dtype", where=where,
            detail=f"cols dtype {idx_dtype} is not int32, the columns the "
                   f"kernels read"))
        return out
    out += _int_args(where, K=k_, w=w_, B=batch)
    if n_pad > INT32_MAX:
        out.append(Violation(
            kind="int32-range", where=where,
            detail=f"x's {n_pad} entries do not fit the int32 columns"))
        return out
    c, v = _host(cols), _host(vals)
    bad = (v != 0) & ((c < 0) | (c >= n_pad))
    if bad.any():
        s, k, w = (int(x) for x in np.argwhere(bad)[0])
        out.append(Violation(
            kind="index-bounds", where=where, round=s,
            detail=f"cols[{s},{k},{w}] = {int(c[s, k, w])} with a nonzero "
                   f"value, outside x's domain [0, {n_pad}) -- the kernel "
                   f"would wrap or drop this term"))
    for launch in _spmv_launches(n_slices, k_, w_, batch, vals):
        if "error" in launch:
            out.append(Violation(kind="grid", where=where,
                                 detail=launch["error"]))
        else:
            out += _grid(launch["blocks"], launch["threads"], where)
    return out[:MAX_VIOLATIONS]


def _spmv_launches(n_slices: int, k_: int, w_: int, batch: int,
                   vals) -> list[dict]:
    """The SpMV launch of a call at ``batch`` columns: B2's one thread a
    row, or B4's variant and shape (``sell_spmv.batched_launch``, with x
    16-byte aligned, as a fresh tensor is)."""
    if batch == 1:
        return [dict(name="sell_spmv", kernel="sell_spmv_kernel<T>",
                     threads=SPMV_THREADS,
                     blocks=_blocks(n_slices * w_, SPMV_THREADS),
                     launches=1)]
    import torch

    from ..kernels.sell_spmv import batched_launch
    dtype = {"float64": torch.float64, "float32": torch.float32}.get(
        _dtype_name(vals), torch.float64)
    try:
        shape = batched_launch(n_slices, k_, w_, batch, dtype, 0)
    except ValueError as err:
        return [dict(name="sell_spmv_batched", error=str(err))]
    return [dict(name="sell_spmv_batched",
                 kernel=f"sell_spmv_batched_kernel<T, "
                        f"{shape.cols_per_thread}, {shape.k_unrolled}>",
                 threads=shape.threads, blocks=shape.blocks, launches=1)]


def plan_launches(plan, batch: int = 1) -> list[dict]:
    """Every kernel launch of one apply and one SpMV of ``plan`` at
    ``batch`` columns: name, kernel, threads a block, blocks, launches per
    call (per apply for the trisolve kernels).  The card's counterpart of
    the reference's VMEM report."""
    out = []
    single = batch == 1
    threads = SINGLE_THREADS if single else BATCHED_THREADS
    if plan.mesh is not None:
        t = plan._precond.tables
        out.append(dict(
            name="hbmc_trisolve_shard_step" + ("" if single else "_batched"),
            kernel="shard_step<T>", threads=BATCHED_THREADS,
            blocks=_blocks(t.lanes * batch, BATCHED_THREADS),
            launches=int(t.cols.shape[0])))
    elif plan.layout == "round_major":
        t = plan._precond.tables
        out.append(dict(
            name="hbmc_trisolve_fused" + ("" if single else "_batched"),
            kernel="segment_single<T, true>" if single
            else "fused_segment_batched<T>", threads=threads,
            blocks=_blocks(t.lanes * batch, threads),
            launches=int(t.segments.size)))
    else:
        for sweep, t in (("fwd", plan._precond.kernel.fwd),
                         ("bwd", plan._precond.kernel.bwd)):
            out.append(dict(
                name=("hbmc_trisolve" if single else "hbmc_trisolve_batched")
                + f" ({sweep})",
                kernel="segment_single<T, false>" if single
                else "sweep_segment_batched<T>", threads=threads,
                blocks=_blocks(int(t.dinv.shape[1]) * batch, threads),
                launches=int(t.segments.size)))
    if plan.spmv_format == "sell":
        # on a mesh sell_spmv_block runs B2 / B4 on the rank's slices
        n_slices, k_, w_ = (int(x) for x in plan._spmv_vals.shape)
        out += _spmv_launches(n_slices, k_, w_, batch, plan._spmv_vals)
    return out


def check_plan_kernels(plan, batch: int = 1) -> list[Violation]:
    """Run the static kernel checks of every kernel the plan launches.

    Round-major: the fused table (B1 at ``batch`` 1, else B3); index: both
    sweep tables (B5 / B6); mesh: this rank's lane block as the shard step
    runs it; a SELL-w SpMV operand: B2 / B4 (``sell_spmv_block`` on a mesh
    runs them on the rank's slices).  An ELL SpMV runs PyTorch ops, with no
    kernel to check.
    """
    out: list[Violation] = []
    sfx = "" if batch == 1 else "_batched"
    if plan.mesh is not None:
        from ..core.mesh import axis_group
        t = plan._precond.tables
        _, _, rank = axis_group(plan.mesh, plan.mesh_axis)
        out += check_shard_step(t.cols, t.vals, t.dinv, plan._precond.lanes,
                                rank * t.lanes, batch=batch,
                                where=f"kernel/hbmc_trisolve_shard_step{sfx}")
    elif plan.layout == "round_major":
        t = plan._precond.tables
        out += check_trisolve_fused(t.cols, t.vals, t.dinv, batch=batch,
                                    where=f"kernel/hbmc_trisolve_fused{sfx}")
    else:
        for sweep, t in (("fwd", plan._precond.kernel.fwd),
                         ("bwd", plan._precond.kernel.bwd)):
            out += check_trisolve_sweep(
                t.cols, t.vals, t.dinv, batch=batch,
                where=f"kernel/hbmc_trisolve{sfx}/{sweep}")
    if plan.spmv_format == "sell":
        out += check_sell_spmv(plan._spmv_vals, plan._spmv_cols,
                               n_pad=int(plan.slab_m), batch=batch,
                               where=f"kernel/sell_spmv{sfx}")
    return out


def assert_plan_kernels(plan, batch: int = 1, context: str = "") -> None:
    violations = check_plan_kernels(plan, batch=batch)
    if violations:
        raise ScheduleError(violations, context=context)
