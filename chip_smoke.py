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
3. Main path: ``build_plan`` + ``plan.solve`` on thermal2 at n = 1,048,576
   (laplace_2d(1024, 1024) with a log-normal coefficient), HBMC, block 16,
   w 8.  CONVERGED in 48 +- 2 iterations, true relres < 1e-6 on the host,
   one trisolve kernel launch per apply (iterations + 1) and one SpMV kernel
   launch per iteration.  A small solve on the card is held against the same
   solve on the CPU (plain path).
4. Times with CUDA events after a warm-up, each beside its bound from the
   bytes it must move: per trisolve apply, per SpMV, per PCG iteration, the
   plain versions, and the cuSPARSE CSR SpMV (``torch.mv`` on a CSR tensor,
   timed as a yardstick only; the port never calls it).

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

KERNELS = {
    "hbmc_trisolve_fused": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/hbmc_trisolve.cu",
        replaces="src/repro/kernels/hbmc_trisolve.py:198"),
    "sell_spmv": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sell_spmv.cu",
        replaces="src/repro/kernels/sell_spmv.py:70"),
}


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


def trisolve_bytes(tables, q) -> int:
    """Each input read once, the (S*R,) output written once."""
    return (tables.cols.numel() * tables.cols.element_size()
            + tables.vals.numel() * tables.vals.element_size()
            + tables.dinv.numel() * tables.dinv.element_size()
            + 2 * q.numel() * q.element_size())


def spmv_bytes(vals, cols, x) -> int:
    n_rows = vals.shape[0] * vals.shape[2]
    return (vals.numel() * vals.element_size()
            + cols.numel() * cols.element_size()
            + x.numel() * x.element_size() + n_rows * x.element_size())


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


def profile_solve(plan, b) -> None:
    """Device time by kernel over one warm ``plan.solve`` (torch.profiler),
    and the device's busy share of the PCG loop's wall time.  The profiler
    adds host cost per op, so the busy share it shows is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        rep = plan.solve(b)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    loop_ms = rep.solve_seconds * 1e3
    if not by_name:
        log(f"profile: no device activity recorded (device busy share: not "
            f"measured); PCG loop {loop_ms:.2f} ms under the profiler")
        return
    busy = sum(by_name.values())
    log(f"profile of one solve: device busy {busy:.2f} ms of the PCG loop's "
        f"{loop_ms:.2f} ms under the profiler ({100 * busy / loop_ms:.1f}%)"
        f"; device ms by kernel:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f}  {name[:90]}")


def run(device: str = "cuda", grid: int = MAIN_GRID, scale: str = "bench",
        iterations: int | None = MAIN_ITERATIONS) -> list[dict]:
    """All four phases; returns the kernel rows of the JSON line.

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
                                     hbmc_trisolve_fused_ref, sell_spmv,
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
        if name == "thermal2":
            plan32 = build_plan(a, dtype=torch.float32, **plan_kw)
            check_kernels(plan32, f"{name}/{scale}", seed=20)
        del plan
    plan_main = build_plan(a_main, **plan_kw)
    check_kernels(plan_main, f"thermal2/n={a_main.shape[0]}", seed=30)
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
    want = ({"hbmc_trisolve_fused": res.iterations + 1,
             "sell_spmv": res.iterations} if on_card else
            {"hbmc_trisolve_fused": 0, "sell_spmv": 0})
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

    # -- 4. times ---------------------------------------------------------------
    log("== 4. times (ms)" + ("" if on_card else
                               " -- CPU rehearsal, not device times"))
    rng = np.random.default_rng(9)
    q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes)), device=dev)
    x = torch.tensor(rng.normal(size=plan._spmv_n), device=dev)
    sv, sc = plan._spmv_vals, plan._spmv_cols
    err_tri = float((hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q)
                     - hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q))
                    .abs().max())
    y_k = sell_spmv(sv, sc, x)
    err_spmv = float((y_k - sell_spmv_ref(sv, sc, x)).abs().max())

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

    reps = 50 if on_card else 2
    tri_ms = time_ms(lambda: hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q),
                     reps, dev)
    tri_plain_ms = time_ms(
        lambda: hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q),
        max(reps // 5, 1), dev)
    spmv_ms = time_ms(lambda: sell_spmv(sv, sc, x), 4 * reps, dev)
    spmv_plain_ms = time_ms(lambda: sell_spmv_ref(sv, sc, x), reps, dev)
    spmv_lib_ms = time_ms(lambda: torch.mv(a_lib, x), 4 * reps, dev)
    rep2 = plan.solve(b)
    iter_ms = rep2.solve_seconds * 1e3 / max(rep2.result.iterations, 1)

    tri_bound, tri_by = bound(trisolve_bytes(t, q),
                              2 * t.vals.numel() + 2 * t.dinv.numel(),
                              plan.dtype)
    spmv_bound, spmv_by = bound(spmv_bytes(sv, sc, x), 2 * sv.numel(),
                                plan.dtype)
    log(f"trisolve apply: kernel {tri_ms:.4f}  plain {tri_plain_ms:.4f}  "
        f"bound {tri_bound:.4f} ({tri_by}, "
        f"{trisolve_bytes(t, q) / 1e6:.1f} MB; {2 * t.n_steps} launches)")
    log(f"SELL SpMV:      kernel {spmv_ms:.4f}  plain {spmv_plain_ms:.4f}  "
        f"bound {spmv_bound:.4f} ({spmv_by}, "
        f"{spmv_bytes(sv, sc, x) / 1e6:.1f} MB)  torch.mv CSR "
        f"{spmv_lib_ms:.4f}")
    log(f"PCG iteration:  {iter_ms:.4f} ms ({rep2.result.iterations} "
        f"iterations in {rep2.solve_seconds * 1e3:.2f} ms); host setup "
        f"{setup_s * 1e3:.1f} ms")
    profile_solve(plan, b)
    return [
        {"name": "hbmc_trisolve_fused", **KERNELS["hbmc_trisolve_fused"],
         "launches": counts["hbmc_trisolve_fused"], "max_abs_err": err_tri,
         "ms": tri_ms, "plain_ms": tri_plain_ms, "bound_ms": tri_bound,
         "bound_by": tri_by, "library_ms": None},
        {"name": "sell_spmv", **KERNELS["sell_spmv"],
         "launches": counts["sell_spmv"], "max_abs_err": err_spmv,
         "ms": spmv_ms, "plain_ms": spmv_plain_ms, "bound_ms": spmv_bound,
         "bound_by": spmv_by, "library_ms": spmv_lib_ms},
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
