#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the HBMC-ICCG solver on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its last line:

1. Environment: card name and power limit, torch / CUDA / nvcc versions;
   build the kernel library from ``src/repro_torch/kernels/csrc``.
2. Kernel vs plain on the card: the fused-trisolve and SELL-w SpMV kernels
   against their plain PyTorch versions, on the plan tables of the five
   paper generators at ``scale="bench"`` (f64, one also f32) and of the
   1M-unknown thermal2 plan.  Max relative error <= 1e-12 (f64), 1e-5 (f32).
   The batched kernels likewise at B in {1, 3, 8} on the bench tables and
   at B = 8 on the 1M tables, and each batched column bitwise equal to the
   single-RHS kernel on that column.
3. Main path: ``build_plan`` + ``plan.solve`` on thermal2 at n = 1,048,576
   (laplace_2d(1024, 1024) with a log-normal coefficient), HBMC, block 16,
   w 8.  CONVERGED in 48 +- 2 iterations, true relres < 1e-6 on the host,
   one trisolve kernel launch per apply (iterations + 1) and one SpMV kernel
   launch per iteration.  A small solve on the card is held against the same
   solve on the CPU (plain path).
3b. Batched path: ``plan.solve_batched`` on the same plan with B = 8
   columns from ``default_rng(11)``: every column CONVERGED with true relres
   < 1e-6 and the iteration count of ``plan.solve`` on that column; launches
   B3 = n_steps + 1, B4 = n_steps, none of the single-RHS kernels.
3c. Serving: a ``SolverService(slab_width=8, quantum=16)`` on a wall clock
   over the same matrix, 24 seeded requests, one with a NaN RHS and one
   with a zero RHS: NaN -> BREAKDOWN, zero -> CONVERGED at 0 iterations,
   the rest CONVERGED at their single-RHS counts; the NaN request's slab
   neighbours and others bitwise equal to ``plan.solve_slab`` on the
   service's cached plan.
4. Times with CUDA events after a warm-up, each beside its bound from the
   bytes it must move: per trisolve apply, per SpMV, per PCG iteration, the
   plain versions, and the cuSPARSE CSR SpMV (``torch.mv`` on a CSR tensor,
   timed as a yardstick only; the port never calls it); the same at B = 8
   for the batched kernels (cuSPARSE SpMM, ``torch.sparse.mm``, as B4's
   yardstick), ms per batched iteration, and the service's solves per
   second.

Its last lines: one JSON object with a row per kernel, the card's name and
power limit from ``nvidia-smi``, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and vector
# (non-tensor-core) rates for the element types the kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.float64": 34e12, "torch.float32": 67e12}

MAIN_GRID = 1024            # laplace_2d(1024, 1024): n = 1,048,576
MAIN_ITERATIONS, ITER_BAND = 48, 2
TOL = {"torch.float64": 1e-12, "torch.float32": 1e-5}

BATCH = 8                   # columns of the batched path and slab width
BATCH_SIZES = (1, 3, 8)     # widths of the batched kernel checks
SERVE_REQUESTS, SERVE_QUANTUM = 24, 16

KERNELS = {
    "hbmc_trisolve_fused": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/hbmc_trisolve.cu",
        replaces="src/repro/kernels/hbmc_trisolve.py:198"),
    "sell_spmv": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sell_spmv.cu",
        replaces="src/repro/kernels/sell_spmv.py:70"),
    "hbmc_trisolve_fused_batched": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/hbmc_trisolve.cu",
        replaces="src/repro/kernels/hbmc_trisolve.py:239"),
    "sell_spmv_batched": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sell_spmv.cu",
        replaces="src/repro/kernels/sell_spmv.py:105"),
}
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def thermal2_matrix(grid: int):
    """The thermal2 analogue at ``grid`` x ``grid``, built as
    ``matrices.paper_problem`` builds it (coefficient from default_rng(1))."""
    import numpy as np

    from repro_torch.core.matrices import laplace_2d
    coeff = np.exp(np.random.default_rng(1).normal(0, 1, size=(grid, grid)))
    return laplace_2d(grid, grid, coeff)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls after
    two warm-up calls (a host clock with a synchronize on the CPU)."""
    import torch
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def loop_ms(solve, rhs, reps: int) -> list[float]:
    """Wall ms per PCG loop trip (the solve's own device-synchronised host
    clock around its loop) over ``reps`` solves, sorted.  The loop is
    host-bound, so its time varies between runs more than a kernel's."""
    out = []
    for _ in range(reps):
        rep = solve(rhs)
        trips = getattr(rep.result, "n_steps", rep.result.iterations)
        out.append(rep.solve_seconds * 1e3 / max(trips, 1))
    return sorted(out)


def spread(ms: list[float]) -> str:
    return (f"median {ms[len(ms) // 2]:.4f} (min {ms[0]:.4f}, max "
            f"{ms[-1]:.4f}, {len(ms)} solves)")


def trisolve_bytes(tables, q) -> int:
    """Each input read once, the (S*R[, B]) output written once."""
    return (tables.cols.numel() * tables.cols.element_size()
            + tables.vals.numel() * tables.vals.element_size()
            + tables.dinv.numel() * tables.dinv.element_size()
            + 2 * q.numel() * q.element_size())


def spmv_bytes(vals, cols, x) -> int:
    """vals, cols and x (n[, B]) read once, y (n_rows[, B]) written once."""
    n_rows = vals.shape[0] * vals.shape[2]
    n_cols = x.numel() // x.shape[0]
    return (vals.numel() * vals.element_size()
            + cols.numel() * cols.element_size()
            + x.numel() * x.element_size()
            + n_rows * n_cols * x.element_size())


def bound(n_bytes: int, n_ops: int, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(plan, label: str, seed: int) -> dict:
    """Kernel vs plain version on one plan's tables; raises past TOL."""
    import numpy as np
    import torch

    from repro_torch.kernels import (hbmc_trisolve_fused,
                                     hbmc_trisolve_fused_ref, sell_spmv,
                                     sell_spmv_ref)
    t = plan._precond.tables
    dev, dt = plan.device, plan.dtype
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes)), device=dev).to(dt)
    x = torch.tensor(rng.normal(size=plan._spmv_n), device=dev).to(dt)
    z = hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q)
    z_ref = hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q)
    y = sell_spmv(plan._spmv_vals, plan._spmv_cols, x)
    y_ref = sell_spmv_ref(plan._spmv_vals, plan._spmv_cols, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    errs = {"hbmc_trisolve_fused": rel_err(z, z_ref),
            "sell_spmv": rel_err(y, y_ref)}
    tol = TOL[str(dt)]
    log(f"  {label:<28} n={plan.n:>8} S={t.n_steps:>3} R={t.lanes:>6} "
        f"K={t.vals.shape[-1]:>2} {str(dt):<14} trisolve rel err "
        f"{errs['hbmc_trisolve_fused']:.3e}  spmv rel err "
        f"{errs['sell_spmv']:.3e}  (tol {tol:g})")
    for name, err in errs.items():
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {label}: {err:.3e} > {tol:g}")
    if not (torch.isfinite(z).all() and torch.isfinite(y).all()):
        raise AssertionError(f"non-finite kernel output on {label}")
    return errs


def check_batched_kernels(plan, label: str, seed: int,
                          sizes=BATCH_SIZES) -> dict:
    """Batched kernels vs their plain versions at each B in ``sizes``, and
    each batched column bitwise equal to the single-RHS kernel on it."""
    import numpy as np
    import torch

    from repro_torch.kernels import (hbmc_trisolve_fused,
                                     hbmc_trisolve_fused_batched,
                                     hbmc_trisolve_fused_batched_ref,
                                     sell_spmv, sell_spmv_batched,
                                     sell_spmv_batched_ref)
    t = plan._precond.tables
    sv, sc = plan._spmv_vals, plan._spmv_cols
    dev, dt = plan.device, plan.dtype
    tol = TOL[str(dt)]
    rng = np.random.default_rng(seed)
    worst = {"hbmc_trisolve_fused_batched": 0.0, "sell_spmv_batched": 0.0}
    for nb in sizes:
        q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes, nb)),
                         device=dev).to(dt)
        x = torch.tensor(rng.normal(size=(plan._spmv_n, nb)),
                         device=dev).to(dt)
        z = hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, q)
        y = sell_spmv_batched(sv, sc, x)
        errs = {"hbmc_trisolve_fused_batched": rel_err(
                    z, hbmc_trisolve_fused_batched_ref(t.cols, t.vals,
                                                       t.dinv, q)),
                "sell_spmv_batched": rel_err(
                    y, sell_spmv_batched_ref(sv, sc, x))}
        for name, err in errs.items():
            if not err <= tol:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {label}, B={nb}: "
                                     f"{err:.3e} > {tol:g}")
            worst[name] = max(worst[name], err)
        if not (torch.isfinite(z).all() and torch.isfinite(y).all()):
            raise AssertionError(f"non-finite batched output on {label}")
        for j in range(nb):
            if not (torch.equal(z[:, j], hbmc_trisolve_fused(
                        t.cols, t.vals, t.dinv, q[..., j].contiguous()))
                    and torch.equal(y[:, j], sell_spmv(
                        sv, sc, x[:, j].contiguous()))):
                raise AssertionError(f"batched column {j} of B={nb} is not "
                                     f"bitwise the single-RHS kernel's on "
                                     f"{label}")
    log(f"  {label:<28} batched B={list(sizes)}: trisolve rel err "
        f"{worst['hbmc_trisolve_fused_batched']:.3e}  spmv rel err "
        f"{worst['sell_spmv_batched']:.3e}; every column bitwise equal to "
        f"the single-RHS kernels")
    return worst


def profile_solve(plan, b, b_batched) -> None:
    """Device time by kernel over one warm ``plan.solve`` and one warm
    ``plan.solve_batched`` (torch.profiler), and the device's busy share of
    each PCG loop: kernel time over the loop's wall time.  Memory copies
    are counted apart: the RHS upload and the solution download happen
    outside the loop (pageable host memory), the per-iteration flag reads
    inside it.  The profiler adds host cost per op, so the busy share it
    shows is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for label, solve, rhs in (("solve", plan.solve, b),
                              (f"solve_batched (B={b_batched.shape[1]})",
                               plan.solve_batched, b_batched)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rep = solve(rhs)
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        loop_ms = rep.solve_seconds * 1e3
        if not by_name:
            log(f"profile of one {label}: no device activity recorded "
                f"(device busy share: not measured); PCG loop "
                f"{loop_ms:.2f} ms under the profiler")
            continue
        copy_ms = sum(ms for name, ms in by_name.items()
                      if name.startswith("Memcpy"))
        kernel_ms = sum(by_name.values()) - copy_ms
        log(f"profile of one {label}: device kernels {kernel_ms:.2f} ms of "
            f"the PCG loop's {loop_ms:.2f} ms under the profiler "
            f"({100 * kernel_ms / loop_ms:.1f}% busy); memory copies "
            f"{copy_ms:.2f} ms; device ms by kernel:")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            log(f"  {ms:9.3f}  {name[:90]}")


def solve_batched_phase(plan, a, on_card: bool):
    """Phase 3b: ``plan.solve_batched`` on B = 8 seeded columns."""
    import numpy as np

    from repro_torch import kernels
    n = a.shape[0]
    b8 = np.random.default_rng(11).normal(size=(n, BATCH))
    kernels.reset_launch_counts()
    rep = plan.solve_batched(b8)
    counts = kernels.launch_counts()
    res = rep.result
    true_relres = (np.linalg.norm(b8 - a @ rep.x, axis=0)
                   / np.linalg.norm(b8, axis=0))
    singles = [plan.solve(b8[:, j]).result.iterations for j in range(BATCH)]
    log(f"solve_batched B={BATCH}: statuses {res.status_names}, iterations "
        f"{res.iterations.tolist()} (plan.solve: {singles}), n_steps "
        f"{res.n_steps}, max true relres {true_relres.max():.3e}, "
        f"{rep.solve_seconds:.3f} s; launches {counts}")
    if res.status_names != ["CONVERGED"] * BATCH:
        raise AssertionError(f"batched path ended {res.status_names}")
    if res.iterations.tolist() != singles:
        raise AssertionError(f"batched counts {res.iterations.tolist()} != "
                             f"single-RHS counts {singles}")
    if not (rep.x.shape == (n, BATCH) and np.isfinite(rep.x).all()
            and (true_relres < 1e-6).all()):
        raise AssertionError(f"bad batched solution: true relres "
                             f"{true_relres}")
    want = dict(NO_LAUNCHES)
    if on_card:
        want.update(hbmc_trisolve_fused_batched=res.n_steps + 1,
                    sell_spmv_batched=res.n_steps)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return rep, b8, counts


def serve_phase(a, plan_kw: dict, on_card: bool):
    """Phase 3c: 24 seeded requests through a ``SolverService``."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serve import SolverService, WallClock
    n = a.shape[0]
    rng = np.random.default_rng(12)
    bs = [rng.normal(size=n) for _ in range(SERVE_REQUESTS)]
    nan_at, zero_at = 3, 10
    bs[nan_at][rng.integers(n)] = np.nan
    bs[zero_at] = np.zeros(n)
    svc = SolverService(slab_width=BATCH, quantum=SERVE_QUANTUM,
                        clock=WallClock(), record_dispatches=True, **plan_kw)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [svc.submit(a, b) for b in bs]
    t1 = time.perf_counter()
    svc.drain()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    done = [svc.completed[r] for r in rids]
    steps = sum(e["steps"] for e in svc.dispatch_log)
    # the plan is read only now, after the service has drained
    plan, cache_status = svc.cache.get(a, **plan_kw)
    if cache_status != "hit":
        raise AssertionError(f"service plan not cached ({cache_status})")
    log(f"service: {len(done)} requests in {wall_s:.3f} s wall "
        f"({len(done) / wall_s:.2f} solves/s; plan build included): "
        f"submits {t1 - t0:.3f} s (canonical CSR + fingerprints of the "
        f"matrix, per request), drain {wall_s - (t1 - t0):.3f} s of which "
        f"plan build {plan.timings.total:.3f} s; "
        f"{len(svc.dispatch_log)} dispatches, {steps} slab steps, "
        f"quarantined {svc.n_quarantined}; launches {counts}")
    want = dict(NO_LAUNCHES)
    if on_card:
        want.update(hbmc_trisolve_fused_batched=len(svc.dispatch_log) + steps,
                    sell_spmv_batched=steps)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    for i, c in enumerate(done):
        want_status = ("BREAKDOWN" if i == nan_at else "CONVERGED")
        if c.status != want_status:
            raise AssertionError(f"request {i} ended {c.status}, expected "
                                 f"{want_status}")
    if done[nan_at].x is not None:
        raise AssertionError("the NaN request returned an iterate")
    if done[zero_at].iterations != 0 or np.any(done[zero_at].x != 0):
        raise AssertionError("the zero request did not converge at 0")
    healthy = [i for i in range(len(done)) if i not in (nan_at, zero_at)]
    for i in healthy:
        single = plan.solve(bs[i]).result.iterations
        if done[i].iterations != single:
            raise AssertionError(f"request {i}: {done[i].iterations} "
                                 f"iterations, plan.solve {single}")
    # the NaN request's slab neighbours, then others, up to 4 at least
    nan_rid = rids[nan_at]
    neighbours = sorted({r for e in svc.dispatch_log if nan_rid in e["rids"]
                         for r in e["rids"]
                         if r is not None and r != nan_rid} - {rids[zero_at]})
    checked = [rids.index(r) for r in neighbours]
    checked += [i for i in healthy if i not in checked][:max(0, 4 -
                                                             len(checked))]
    for i in checked:
        c = done[i]
        oracle = plan.solve_slab(bs[i], slab_width=BATCH, slot=c.slot)
        if not np.array_equal(c.x, oracle.x):
            raise AssertionError(f"request {i} (slot {c.slot}) is not "
                                 f"bitwise solve_slab")
    log(f"service: statuses as expected; {len(healthy)} healthy counts "
        f"equal plan.solve's; requests {checked} (the NaN request's "
        f"neighbours {[rids.index(r) for r in neighbours]}) bitwise equal "
        f"to plan.solve_slab")
    return wall_s, len(done), counts


def run(device: str = "cuda", grid: int = MAIN_GRID, scale: str = "bench",
        iterations: int | None = MAIN_ITERATIONS) -> list[dict]:
    """All phases; returns the kernel rows of the JSON line.

    ``grid``/``scale``/``iterations`` exist so the same phases can be
    rehearsed at a small size on the CPU (``iterations=None`` skips the
    count check there); the script itself runs them at full size on the
    card.
    """
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch import kernels
    from repro_torch.core import (PAPER_PROBLEMS, PAPER_SHIFTS, build_plan,
                                  paper_problem)
    from repro_torch.core.sell import permute_round_major
    from repro_torch.kernels import (_build, hbmc_trisolve_fused,
                                     hbmc_trisolve_fused_batched,
                                     hbmc_trisolve_fused_batched_ref,
                                     hbmc_trisolve_fused_ref, sell_spmv,
                                     sell_spmv_batched, sell_spmv_batched_ref,
                                     sell_spmv_ref)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    plan_kw = dict(method="hbmc", block_size=16, w=8, spmv_format="sell",
                   device=device)

    # -- 1. environment + build ---------------------------------------------
    log("== 1. environment")
    if on_card:
        log("card:", card_line())
        log("torch", torch.__version__, "cuda", torch.version.cuda,
            "device", torch.cuda.get_device_name(dev))
        nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()
        log("nvcc:", nvcc[-1])
        t0 = time.perf_counter()
        lib = _build.load_library()
        log(f"kernel library {lib.path.name}: built in "
            f"{lib.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f}"
            " s)")
        for line in lib.log.splitlines():
            if "registers" in line or line.startswith("=="):
                log("  ", line.strip())

    # -- 2. kernel vs plain ---------------------------------------------------
    log("== 2. kernel vs plain on the card" if on_card else
        "== 2. kernel vs plain (CPU rehearsal: plain vs plain)")
    a_main = thermal2_matrix(grid)
    for i, name in enumerate(PAPER_PROBLEMS):
        a, _ = paper_problem(name, scale=scale)
        plan = build_plan(a, shift=PAPER_SHIFTS.get(name, 0.0), **plan_kw)
        check_kernels(plan, f"{name}/{scale}", seed=10 + i)
        check_batched_kernels(plan, f"{name}/{scale}", seed=40 + i)
        if name == "thermal2":
            plan32 = build_plan(a, dtype=torch.float32, **plan_kw)
            check_kernels(plan32, f"{name}/{scale}", seed=20)
            check_batched_kernels(plan32, f"{name}/{scale}", seed=50)
        del plan
    plan_main = build_plan(a_main, **plan_kw)
    check_kernels(plan_main, f"thermal2/n={a_main.shape[0]}", seed=30)
    check_batched_kernels(plan_main, f"thermal2/n={a_main.shape[0]}",
                          seed=31, sizes=(BATCH,))
    del plan_main

    # -- 3. main path ---------------------------------------------------------
    log("== 3. main path: build_plan + solve, thermal2 "
        f"n={a_main.shape[0]} nnz={a_main.nnz}")
    b = np.random.default_rng(7).normal(size=a_main.shape[0])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plan = build_plan(a_main, **plan_kw)
    setup_s = time.perf_counter() - t0
    rep = plan.solve(b)
    counts = kernels.launch_counts()
    res = rep.result
    true_relres = float(np.linalg.norm(b - a_main @ rep.x)
                        / np.linalg.norm(b))
    t = plan._precond.tables
    log(f"setup {setup_s:.3f} s ({plan.timings}); colors {plan.n_colors}, "
        f"S={t.n_steps}, tables {tuple(t.cols.shape)}, SELL "
        f"{tuple(plan._spmv_vals.shape)}")
    log(f"solve: status {res.status}, iterations {res.iterations}, relres "
        f"{res.relres:.3e}, true relres {true_relres:.3e}, "
        f"{rep.solve_seconds:.3f} s; launches {counts}")
    if res.status != "CONVERGED":
        raise AssertionError(f"main path ended {res.status}")
    if iterations is not None and abs(res.iterations - iterations) > \
            ITER_BAND:
        raise AssertionError(f"{res.iterations} iterations, expected "
                             f"{iterations} +- {ITER_BAND}")
    if not (rep.x.shape == (a_main.shape[0],) and np.isfinite(rep.x).all()
            and true_relres < 1e-6):
        raise AssertionError(f"bad solution: true relres {true_relres:.3e}")
    want = dict(NO_LAUNCHES)
    if on_card:
        want.update(hbmc_trisolve_fused=res.iterations + 1,
                    sell_spmv=res.iterations)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    # the same small solve through the kernels and through the plain path
    a_small = thermal2_matrix(48)
    b_small = np.random.default_rng(8).normal(size=a_small.shape[0])
    r_dev = build_plan(a_small, **plan_kw).solve(b_small)
    r_cpu = build_plan(a_small, **{**plan_kw, "device": "cpu"}).solve(b_small)
    small_err = float(np.abs(r_dev.x - r_cpu.x).max()
                      / np.abs(r_cpu.x).max())
    log(f"small solve (n={a_small.shape[0]}): {device} "
        f"{r_dev.result.iterations} it vs cpu {r_cpu.result.iterations} it, "
        f"solution rel diff {small_err:.3e}")
    if (r_dev.result.status != "CONVERGED"
            or abs(r_dev.result.iterations - r_cpu.result.iterations) > 1
            or small_err > 1e-6):
        raise AssertionError("small solve disagrees with the CPU path")

    # -- 3b. batched path ----------------------------------------------------
    log(f"== 3b. batched path: plan.solve_batched, B={BATCH}, same plan")
    rep_b, b8, counts_b = solve_batched_phase(plan, a_main, on_card)

    # -- 3c. serving ----------------------------------------------------------
    log(f"== 3c. serving: SolverService(slab_width={BATCH}, "
        f"quantum={SERVE_QUANTUM}), {SERVE_REQUESTS} requests, same matrix")
    serve_s, serve_n, _ = serve_phase(a_main, plan_kw, on_card)

    # -- 4. times -------------------------------------------------------------
    log("== 4. times (ms)" + ("" if on_card else
                               " -- CPU rehearsal, not device times"))
    rng = np.random.default_rng(9)
    q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes)), device=dev)
    x = torch.tensor(rng.normal(size=plan._spmv_n), device=dev)
    qb = torch.tensor(rng.normal(size=(t.n_steps, t.lanes, BATCH)),
                      device=dev)
    xb = torch.tensor(rng.normal(size=(plan._spmv_n, BATCH)), device=dev)
    sv, sc = plan._spmv_vals, plan._spmv_cols

    def max_abs(got, want) -> float:
        return float((got - want).abs().max())

    err_tri = max_abs(hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q),
                      hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q))
    y_k = sell_spmv(sv, sc, x)
    err_spmv = max_abs(y_k, sell_spmv_ref(sv, sc, x))
    err_tri_b = max_abs(
        hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, qb),
        hbmc_trisolve_fused_batched_ref(t.cols, t.vals, t.dinv, qb))
    y_kb = sell_spmv_batched(sv, sc, xb)
    err_spmv_b = max_abs(y_kb, sell_spmv_batched_ref(sv, sc, xb))

    a_rm = sp.csr_matrix(permute_round_major(plan._sysd.a_bar, plan._rm))
    with warnings.catch_warnings():
        # PyTorch's notes that CSR support is beta and that invariant
        # checks are off; the operand is scipy's own CSR, checked below
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        a_lib = torch.sparse_csr_tensor(
            torch.tensor(a_rm.indptr, dtype=torch.int64),
            torch.tensor(a_rm.indices, dtype=torch.int64),
            torch.tensor(a_rm.data), size=a_rm.shape).to(dev)
    y_lib = torch.mv(a_lib, x)
    lib_err = rel_err(y_k[:plan._spmv_n], y_lib)
    if not lib_err <= 1e-12:
        raise AssertionError(f"SpMV disagrees with torch.mv on CSR: "
                             f"{lib_err:.3e}")
    y_lib_b = torch.sparse.mm(a_lib, xb)
    lib_err_b = rel_err(y_kb[:plan._spmv_n], y_lib_b)
    if not lib_err_b <= 1e-12:
        raise AssertionError(f"batched SpMV disagrees with torch.sparse.mm "
                             f"on CSR: {lib_err_b:.3e}")

    reps = 50 if on_card else 2
    tri_ms = time_ms(lambda: hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q),
                     reps, dev)
    tri_plain_ms = time_ms(
        lambda: hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q),
        max(reps // 5, 1), dev)
    spmv_ms = time_ms(lambda: sell_spmv(sv, sc, x), 4 * reps, dev)
    spmv_plain_ms = time_ms(lambda: sell_spmv_ref(sv, sc, x), reps, dev)
    spmv_lib_ms = time_ms(lambda: torch.mv(a_lib, x), 4 * reps, dev)
    solve_reps = 5 if on_card else 1
    iter_ms = loop_ms(plan.solve, b, solve_reps)
    tri_b_ms = time_ms(
        lambda: hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, qb),
        reps, dev)
    tri_b_plain_ms = time_ms(
        lambda: hbmc_trisolve_fused_batched_ref(t.cols, t.vals, t.dinv, qb),
        max(reps // 5, 1), dev)
    spmv_b_ms = time_ms(lambda: sell_spmv_batched(sv, sc, xb), 4 * reps, dev)
    spmv_b_plain_ms = time_ms(lambda: sell_spmv_batched_ref(sv, sc, xb),
                              reps, dev)
    spmv_b_lib_ms = time_ms(lambda: torch.sparse.mm(a_lib, xb), 4 * reps,
                            dev)
    iter_b_ms = loop_ms(plan.solve_batched, b8, solve_reps)
    # the single-RHS loop once more, after the batched work, as a check on
    # how much the host loop's time depends on what ran before it
    iter_late_ms = loop_ms(plan.solve, b, solve_reps)

    def tri_bound(qq):
        return bound(trisolve_bytes(t, qq),
                     (2 * t.vals.numel() + 2 * t.dinv.numel())
                     * (qq.numel() // (t.n_steps * t.lanes)), plan.dtype)

    def spmv_bound(xx):
        return bound(spmv_bytes(sv, sc, xx),
                     2 * sv.numel() * (xx.numel() // xx.shape[0]),
                     plan.dtype)

    tri_bnd, tri_by = tri_bound(q)
    spmv_bnd, spmv_by = spmv_bound(x)
    tri_b_bnd, tri_b_by = tri_bound(qb)
    spmv_b_bnd, spmv_b_by = spmv_bound(xb)
    log(f"trisolve apply: kernel {tri_ms:.4f}  plain {tri_plain_ms:.4f}  "
        f"bound {tri_bnd:.4f} ({tri_by}, "
        f"{trisolve_bytes(t, q) / 1e6:.1f} MB; {2 * t.n_steps} launches)")
    log(f"SELL SpMV:      kernel {spmv_ms:.4f}  plain {spmv_plain_ms:.4f}  "
        f"bound {spmv_bnd:.4f} ({spmv_by}, "
        f"{spmv_bytes(sv, sc, x) / 1e6:.1f} MB)  torch.mv CSR "
        f"{spmv_lib_ms:.4f}")
    log(f"PCG iteration:  {spread(iter_ms)} ms; host setup "
        f"{setup_s * 1e3:.1f} ms")
    log(f"batched trisolve apply, B={BATCH}: kernel {tri_b_ms:.4f}  plain "
        f"{tri_b_plain_ms:.4f}  bound {tri_b_bnd:.4f} ({tri_b_by}, "
        f"{trisolve_bytes(t, qb) / 1e6:.1f} MB; {2 * t.n_steps} launches)")
    log(f"batched SELL SpMV, B={BATCH}: kernel {spmv_b_ms:.4f}  plain "
        f"{spmv_b_plain_ms:.4f}  bound {spmv_b_bnd:.4f} ({spmv_b_by}, "
        f"{spmv_bytes(sv, sc, xb) / 1e6:.1f} MB)  torch.sparse.mm CSR "
        f"{spmv_b_lib_ms:.4f}")
    iter_b_med = iter_b_ms[len(iter_b_ms) // 2]
    log(f"batched PCG iteration, B={BATCH}: {spread(iter_b_ms)} ms, "
        f"{iter_b_med / BATCH:.4f} ms per column at the median")
    log(f"PCG iteration again, after the batched timings: "
        f"{spread(iter_late_ms)} ms")
    log(f"service: {serve_n} requests in {serve_s:.3f} s wall, "
        f"{serve_n / serve_s:.2f} solves/s (plan build included)")
    profile_solve(plan, b, b8)

    def row(name, launches, err, ms, plain_ms, bnd, by, lib_ms):
        return {"name": name, **KERNELS[name], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}

    return [
        row("hbmc_trisolve_fused", counts["hbmc_trisolve_fused"], err_tri,
            tri_ms, tri_plain_ms, tri_bnd, tri_by, None),
        row("sell_spmv", counts["sell_spmv"], err_spmv, spmv_ms,
            spmv_plain_ms, spmv_bnd, spmv_by, spmv_lib_ms),
        row("hbmc_trisolve_fused_batched",
            counts_b["hbmc_trisolve_fused_batched"], err_tri_b, tri_b_ms,
            tri_b_plain_ms, tri_b_bnd, tri_b_by, None),
        row("sell_spmv_batched", counts_b["sell_spmv_batched"], err_spmv_b,
            spmv_b_ms, spmv_b_plain_ms, spmv_b_bnd, spmv_b_by,
            spmv_b_lib_ms),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    rows = run("cuda")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
