#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the HBMC-ICCG solver, and its LM serving
and training paths, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its last line:

1. Environment: card name and power limit, torch / CUDA / nvcc versions;
   build the kernel library from ``src/repro_torch/kernels/csrc``.
2. Kernel vs plain on the card: the fused-trisolve and SELL-w SpMV kernels
   against their plain PyTorch versions, on the plan tables of the five
   paper generators at ``scale="bench"`` (f64, one also f32) and of the
   1M-unknown thermal2 plan.  Max relative error <= 1e-12 (f64), 1e-5 (f32).
   The batched kernels likewise at B in {1, 2, 3, 8} on the bench tables
   and the 1M tables (B4 runs its scalar variant at B = 1 and 3 and its
   vector variant at B = 8, and at B = 2 in f64), and each batched column
   bitwise equal to the single-RHS kernel on that column.  The
   single-sweep kernels (B5, B6) on both sweep tables of the index-layout
   plans of the same matrices.  Every trisolve kernel (B1, B3, B5, B6)
   launches once per barrier-free segment of its table and is held
   bitwise (max error 0.0) to its plain version and to the same kernel cut
   into one launch per step, with one CUDA launch per segment (the
   segment count of each plan is printed); 20 repeated calls of each on
   the 1M tables give one result bit for bit.  The shard step of the
   mesh path (single RHS and batched, on the same tables, f64 and f32):
   its 2S launches over the whole lane range on a NaN-filled state
   bitwise its plain version and B1's / B3's per-step cut, and two lane
   blocks run in turn with the gather done by hand bitwise B1 / B3.
3. Main path: ``build_plan`` + ``plan.solve`` on thermal2 at n = 1,048,576
   (laplace_2d(1024, 1024) with a log-normal coefficient), HBMC, block 16,
   w 8.  CONVERGED in 48 +- 2 iterations, true relres < 1e-6 on the host.
   The PCG loops run blocks of k masked steps, replayed as CUDA graphs
   (``repro_torch.core.device_loop``), so a solve launches ``1 + k x
   blocks`` trisolve applies (3 CUDA launches each, one per segment) and
   ``k x blocks`` SpMVs, masked steps included, with ``blocks = ceil(trips
   / k)``, one flag read per block and one before it, and one capture.
   Every phase from here to 3d checks those counts, the CUDA launches each
   wrapper reports (one per segment of B1 / B3 / B5 / B6, one per call of
   B2 / B4) and the wrapper calls.  The graph cache: a warm solve and a
   ``refactor`` to A + 0.37 diag(A) and back keep one captured graph and
   the first solve's bits; a small refactored solve is bitwise a cold
   plan's.  The main plans' barrier-free segments, recomputed and timed on
   the host: [0, 16, 48] for the fused table, [0, 16] for each sweep.  A
   small solve on the card is held against the same solve on the CPU.
3b. Batched path: ``plan.solve_batched`` on the same plan with B = 8
   columns from ``default_rng(11)``: every column CONVERGED with true relres
   < 1e-6 and the iteration count of ``plan.solve`` on that column; launches
   B3 = 1 + k x blocks, B4 = k x blocks for n_steps trips, none of the
   single-RHS kernels; CUDA launches of B3 = 3 per apply.
3c. Serving: a ``SolverService(slab_width=8, quantum=16)`` on a wall clock
   over the same matrix, 24 seeded requests, one with a NaN RHS and one
   with a zero RHS: NaN -> BREAKDOWN, zero -> CONVERGED at 0 iterations,
   the rest CONVERGED at their single-RHS counts; the NaN request's slab
   neighbours and others bitwise equal to ``plan.solve_slab`` on the
   service's cached plan; B3 = dispatches + k x blocks, blocks summed
   over the dispatches' trips; one graph captured.
3d. Index layout: ``build_plan(..., layout="index")`` on the same matrix:
   ``plan.solve`` CONVERGED in 48 +- 2 iterations, true relres < 1e-6, two
   single-sweep launches per apply (2 x (1 + k x blocks), 2 CUDA launches
   each) and k x blocks SpMVs; ``plan.solve_batched`` on the
   8 columns, each at its index-plan ``plan.solve`` count, with 2 CUDA
   launches per B6 sweep; one preconditioner apply bitwise
   equal, on every live entry, to the round-major plan's fused apply of the
   same vector; a small index solve on the card against the CPU.
3e. Smoother: GS (omega 1) and SOR (omega 1.5) on the index plan's
   HBMC-ordered 1M system, 20 sweeps each with finite, strictly decreasing
   residuals; at a small size the card's residual history equal to the
   CPU's to rtol 1e-12.
4. Times with CUDA events after a warm-up, each beside its bound from the
   bytes it must move: per trisolve apply (B1 in turns A B C C B A: A
   B3's body at B = 1 with the segments, B B1 with the segments, C B1 one
   launch per step; device time of each under the profiler), per SpMV,
   per PCG iteration, the plain versions, and the cuSPARSE CSR SpMV
   (``torch.mv`` on a CSR tensor, timed as a yardstick only; the port
   never calls it), B2 through its wrapper and through the wrapper's
   undecorated body in turns (what the wrappers' bookkeeping for
   ``repro_torch.analysis`` costs a host-issued call); the same at B = 8 for the batched kernels (cuSPARSE
   SpMM, ``torch.sparse.mm``, as B4's yardstick; B4's variant, registers
   and launch shape, B4 on local cols (each row's entries at the row
   itself: x read once, in order), its scalar variant on an x one element
   off its 16-byte boundary, and a device copy moving B4's bytes; B3 in
   turns with its tables' segments and one launch per step, the
   per-round launch pattern), ms per batched iteration, and the service's
   solves per second; per single sweep B5 (in turns as B1), and B6 at B = 8 (in
   turns as B3; cuSPARSE SpSV / SpSM, ``torch.triangular_solve`` on a CSR
   factor, as their yardstick where the installed torch takes one), the
   index layout's ms per iteration and per batched column, and ms per
   smoother sweep.  Every PCG loop (round-major and index, one RHS and
   B = 8) replayed as graphs against the same loop run eagerly block by
   block, in turns A B B A at k = 1, 4, 8, 16: ms per iteration, the
   capture's seconds, the replayed result bitwise the eager one; both
   forms under the profiler, with the device's busy share under it and
   without it.
3f. Mesh, run last: a one-rank process group (NCCL on the card) and a
   ``("data",)`` ``DeviceMesh``; ``build_plan(..., mesh=mesh,
   lane_multiple=4)`` on the 1M matrix (the lane layout of a 4-way
   mesh).  ``plan.solve``: CONVERGED in 48 +- 2 iterations, true relres <
   1e-6, x bitwise the single-device plan built with ``lane_multiple=4``;
   ``plan.solve_batched`` on the 8 columns: each at its mesh
   ``plan.solve`` count and bitwise the single-device plan.  Launches:
   2S shard steps per apply (``1 + k x blocks`` applies), ``k x blocks``
   ``sell_spmv_block`` calls (B2 / B4), no B1 / B3; all-gathers 2S per
   apply and one per SpMV; the loop captured as a CUDA graph with NCCL
   inside ("graph: true").  ms per iteration beside the single-device
   plan's, a ``refactor`` round trip keeping the capture, and the shard
   steps' and ``sell_spmv_block``'s times against their plain versions
   and bounds; before the group is destroyed, phase 3g's mesh part:
   ``analysis.check_plan_collectives`` (2S all-gathers an apply, one a
   SpMV, no all-reduce in a solve), the shard step's kernel checks and
   ``validate_plan(mesh plan, "full")`` on the built plan (its lane block
   gathered over the mesh axis; timed, no finding); then the index
   layout's mesh step, ``partition.lower_solver_step`` on the index tables
   of ``laplace_2d(32, 32)`` (HBMC block 8, w 4, ELL): one PCG iteration
   with both sweeps, captured as a CUDA graph after an eager first call,
   five replays bitwise the eager iteration, 2S sweep all-gathers and one
   SpMV all-gather per replay, replayed and eager ms per iteration.
3g. Analysis (``repro_torch.analysis``), run after 3f, on the 1M matrix:
   ``validate_plan`` in the modes cheap, full and deep on a plan built with
   ``validate="off"``, each timed ("full" includes ``check_segments`` on
   the (64, 32768, 4) fused table, whose segments it computes), and
   ``build_plan(validate=m)`` for each mode with its ``pack`` seconds;
   ``check_plan_kernels`` at B = 1 and 8 and the launch shapes;
   ``traffic_report`` (the reference's static terms, and the kernel terms
   with the bytes the wrappers saw in one apply and one SpMV); the op
   budgets of the eager apply, SpMV and PCG iteration and the dtype flow
   of the seven paths, with B1 / B2 as opaque nodes; the fused table's cut
   with its middle start removed (``[0, 48]`` for ``[0, 16, 48]``), which
   ``check_segments`` must witness as a segment race and which is never
   launched; a second service run of 8 requests through
   ``PlanCache(validate="full")``, with the admission's seconds; and
   ``python -m repro_torch.analysis --problems laplace2d,thermal2 --scale
   tiny --validate deep --dtype-flow --contracts --traffic`` in a
   subprocess, which must exit 0.  Every finding list must be empty.
5. Examples, run last: each twin of the five solver examples
   (``repro_torch.examples``: quickstart, timestepping, serve_solver,
   rnn_as_trisolve, and iccg_fem at ``--scale small``) on the CPU and on
   the card; their counts (iterations, colors, rounds, occupancy, cache
   statistics, statuses) must be equal, and the card's run must launch the
   twin's kernels.  Then ``iccg_fem --scale bench`` on each of the five
   paper datasets (32,000-123,904 unknowns; MC, BMC, HBMC with ELL and
   HBMC with SELL: 20 plans): every row CONVERGED with true relres < 1e-6
   on the host, its iterations, setup, cold solve and warm solve (a
   second solve of the row's plan, bitwise the first) beside the card's
   name and power limit, and whether BMC and HBMC took equal counts.
6. LM serving (``repro_torch.serve.step`` over ``repro_torch.models``;
   PyTorch ops, no kernel of the port: the counters stay 0), TF32 off:
   6a the ten smoke configs in f32, drawn on the CPU and copied to the
   card: prefill logits and six decode steps fed the CPU's greedy tokens
   (stub frontends: seeded embeddings) within rel 1e-4 of the CPU, and
   the greedy tokens' agreement; 6b mamba2-130m at its full config in f32,
   batch 2, a 300-token prompt (a 256-token SSD chunk and a padded one),
   16 new tokens: the card within rel 1e-4 of the CPU, and decode within
   rel 1e-3 of the full forward over prompt and fed tokens; 6c qwen2.5-3b
   at its full config (36 layers, d 2048, vocab 151,936; 3.397e9
   parameters, 6.79 GB of bf16) drawn on the card, bf16 cache, batch 4, a
   1,536-token prompt (two query chunks of ``flash_core``), 64 new tokens:
   prefill ms, decode step ms (median, p84, n 64; device-synchronised),
   tokens per second of decode and of ``greedy_generate``, peak
   ``max_memory_allocated`` (and what the process held before), the byte
   floor (weights / 3.35 TB/s), profiles of one prefill and four decode
   steps; the decode chain again in turns with the garbage collector on
   and off (the collector's ms by generation, the steps' CPU ms, a probe
   of the host's cost of fixed work before each turn), in this process
   and in a new one that holds only the model, where the collector is
   also frozen, the heap trimmed, a profiler session run, and 4 GB of the
   device and 4 GB of the host with 100,000 small objects held; gates:
   decode logits against the full forward over prompt and generated
   tokens, and the bf16 prefill against the same weights upcast to f32,
   each within 5e-2 x max|logit|.
7. LM training (``repro_torch.train`` over ``repro_torch.models``; PyTorch
   ops, no kernel of the port: the counters stay 0), TF32 off: 7a the
   flash backward (the ``torch.autograd.Function`` of ``flash_core``) at
   one qwen2.5-3b attention layer of the training shape (B 4, S 2,048, KV
   2, G 8, hd 128; two query chunks) against autograd through the plain
   forward loop, f32, rel 1e-4, and its forward / backward ms in f32 and
   bf16; 7b one ``train_step`` of each of the ten smoke configs, f32,
   drawn on the CPU and copied to the card: every leaf's gradient within
   1e-4 x max(1, max|grad|) of the CPU's, the loss and grad norm within
   rel 1e-4; 7c the twin of examples/train_lm.py through
   ``launch.train.main`` (mamba2-130m's full config in bf16, batch 4 x
   256, lr 1e-3), 30 steps with checkpoints every 10 in a temporary
   directory, then ``LATEST`` pointed back at step 20 and a resume with the
   same ``--steps``: its losses within rel 1e-5 of the straight run's
   (bitwise printed), the last 5 losses' mean below the first 5's, ms a
   step; 7d qwen2.5-3b at its full width (seed-0 bf16 weights drawn on the
   card, f32 AdamW state, batch 4 x 2,048 from the synthetic pipeline,
   remat on), 6 steps: the step-0 loss against the same weights upcast to
   f32 within rel 5e-2, finite losses, a finite grad norm above 0, moved
   parameters; ms a step (median of steps 2-6), tokens/s, model TFLOP a
   step (6 x the parameters but the embedding x tokens) and their share of
   989 TFLOP/s, peak ``max_memory_allocated``, and one profiled step by
   kernel and by class.

Its last lines: one JSON object with a row per kernel (``launches`` are
wrapper calls on the main path, ``cuda_launches`` the CUDA launches they
issued), the card's name and power limit from ``nvidia-smi``, then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import gc
import json
import os
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_GRID = 1024            # laplace_2d(1024, 1024): n = 1,048,576
MAIN_ITERATIONS, ITER_BAND = 48, 2
TOL = {"torch.float64": 1e-12, "torch.float32": 1e-5}

BATCH = 8                   # columns of the batched path and slab width
BATCH_SIZES = (1, 2, 3, 8)  # widths of the batched kernel checks
SERVE_REQUESTS, SERVE_QUANTUM = 24, 16
LOOP_KS = (1, 4, 8, 16)     # steps per flag read timed in phase 4
SMOOTHER_SWEEPS = 20
MESH_LANE_MULTIPLE = 4      # phase 3f: the lane layout of a 4-way mesh

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
    "hbmc_trisolve": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/hbmc_trisolve.cu",
        replaces="src/repro/kernels/hbmc_trisolve.py:74"),
    "hbmc_trisolve_batched": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/hbmc_trisolve.cu",
        replaces="src/repro/kernels/hbmc_trisolve.py:111"),
    # the mesh path: the shard step is the kernel of the reference's jnp
    # per-device body of _dist_substitute_fused (no Pallas site)
    "hbmc_trisolve_shard_step": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/hbmc_trisolve.cu",
        replaces="src/repro/core/trisolve.py:262"),
    "hbmc_trisolve_shard_step_batched": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/hbmc_trisolve.cu",
        replaces="src/repro/core/trisolve.py:262"),
    "sell_spmv_block": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sell_spmv.cu",
        replaces="src/repro/kernels/sell_spmv.py:137"),
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


def device_ms(fn, reps: int, device) -> float | None:
    """Device ms per call of ``fn``: its kernels' time under torch.profiler
    over ``reps`` calls after one warm-up call; None off the card or where
    the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps if us else None


def cuda_launches_per_call(fn) -> int:
    """CUDA launches of the port's kernels in one call of ``fn``."""
    from repro_torch import kernels
    before = kernels.cuda_launch_counts()
    fn()
    return sum(v - before[k] for k, v in kernels.cuda_launch_counts().items())


def loop_ms(solve, rhs, reps: int) -> list[float]:
    """Wall ms per PCG loop trip (the solve's own device-synchronised host
    clock around its loop) over ``reps`` solves, sorted."""
    out = []
    for _ in range(reps):
        rep = solve(rhs)
        trips = getattr(rep.result, "n_steps", rep.result.iterations)
        out.append(rep.solve_seconds * 1e3 / max(trips, 1))
    return sorted(out)


def fmt_ms(ms: float | None) -> str:
    return "none" if ms is None else f"{ms:.4f}"


def spread(ms: list[float]) -> str:
    return (f"median {ms[len(ms) // 2]:.4f} (min {ms[0]:.4f}, max "
            f"{ms[-1]:.4f}, {len(ms)} solves)")


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
    z = check_segmented(hbmc_trisolve_fused, hbmc_trisolve_fused_ref, t, q,
                        f"B1 on {label}")
    z_ref = hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q)
    y = sell_spmv(plan._spmv_vals, plan._spmv_cols, x)
    y_ref = sell_spmv_ref(plan._spmv_vals, plan._spmv_cols, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    errs = {"hbmc_trisolve_fused": rel_err(z, z_ref),
            "sell_spmv": rel_err(y, y_ref)}
    tol = TOL[str(dt)]
    log(f"  {label:<28} n={plan.n:>8} S={t.n_steps:>3} R={t.lanes:>6} "
        f"K={t.vals.shape[-1]:>2} {str(dt):<14} B1 in {t.segments.size} "
        f"segments, bitwise the plain version and the per-step cut; spmv "
        f"rel err {errs['sell_spmv']:.3e}  (tol {tol:g})")
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
    from repro_torch.kernels.sell_spmv import batched_launch
    t = plan._precond.tables
    sv, sc = plan._spmv_vals, plan._spmv_cols
    dev, dt = plan.device, plan.dtype
    tol = TOL[str(dt)]
    rng = np.random.default_rng(seed)
    worst = {"hbmc_trisolve_fused_batched": 0.0, "sell_spmv_batched": 0.0}
    variants = {}
    for nb in sizes:
        q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes, nb)),
                         device=dev).to(dt)
        x = torch.tensor(rng.normal(size=(plan._spmv_n, nb)),
                         device=dev).to(dt)
        z = check_segmented(hbmc_trisolve_fused_batched,
                            hbmc_trisolve_fused_batched_ref, t, q,
                            f"B3 on {label}, B={nb}")
        y = sell_spmv_batched(sv, sc, x)
        variants[nb] = ("vector" if batched_launch(
            *sv.shape, nb, dt, x.data_ptr() % 16).vector else "scalar")
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
                        t.cols, t.vals, t.dinv, q[..., j].contiguous(),
                        segments=t.segments))
                    and torch.equal(y[:, j], sell_spmv(
                        sv, sc, x[:, j].contiguous()))):
                raise AssertionError(f"batched column {j} of B={nb} is not "
                                     f"bitwise the single-RHS kernel's on "
                                     f"{label}")
    if len(sizes) > 1 and set(variants.values()) != {"vector", "scalar"}:
        raise AssertionError(f"B4 ran {variants} on {label}, not both its "
                             f"variants")
    log(f"  {label:<28} batched B={list(sizes)}: B3 in "
        f"{t.segments.size} segments of {2 * t.n_steps} steps, bitwise the "
        f"plain version and the per-step cut; spmv rel err "
        f"{worst['sell_spmv_batched']:.3e} ({variants}); every column "
        f"bitwise equal to the single-RHS kernels")
    return worst


def check_segmented(fn, ref, t, q, label: str):
    """A trisolve kernel (B1 / B3 ``fn`` on fused tables, or B5 / B6 on a
    sweep table ``t``) with the tables' segments: bitwise its plain version
    ``ref``, bitwise the same kernel cut into one launch per step
    (``np.arange(G)``), and one CUDA launch per segment.  Returns its
    result."""
    import numpy as np
    import torch

    from repro_torch import kernels
    before = kernels.cuda_launch_counts()
    z = fn(t.cols, t.vals, t.dinv, q, segments=t.segments)
    launched = {k: v - before[k] for k, v in
                kernels.cuda_launch_counts().items()}
    z_step = fn(t.cols, t.vals, t.dinv, q,
                segments=np.arange(t.cols.shape[0]))
    if q.device.type == "cuda":
        torch.cuda.synchronize(q.device)
        if sum(launched.values()) != t.segments.size:
            raise AssertionError(f"{label}: {launched} CUDA launches for "
                                 f"{t.segments.size} segments")
    if not torch.equal(z, ref(t.cols, t.vals, t.dinv, q)):
        raise AssertionError(f"{label}: not bitwise its plain version")
    if not torch.equal(z, z_step):
        raise AssertionError(f"{label}: segments differ from one launch "
                             f"per step")
    return z


def check_repeats(fn, t, fused: bool, nb: int | None, seed: int,
                  label: str, reps: int = 20) -> None:
    """``reps`` calls of a trisolve kernel (B1 / B3 on fused tables, B5 /
    B6 on a sweep table; ``nb`` None for the single-RHS ones) on one input
    give one result bit for bit: a race between lanes would show as a
    changed bit."""
    import numpy as np
    import torch
    n_slices = t.cols.shape[0] // (2 if fused else 1)
    q = torch.tensor(np.random.default_rng(seed).normal(
        size=(n_slices, t.cols.shape[1]) + (() if nb is None else (nb,))),
        device=t.cols.device).to(t.vals.dtype)
    z0 = fn(t.cols, t.vals, t.dinv, q, segments=t.segments)
    for i in range(reps - 1):
        if not torch.equal(fn(t.cols, t.vals, t.dinv, q, segments=t.segments),
                           z0):
            raise AssertionError(f"{label}: call {i + 2} of {reps} differs "
                                 f"from the first")
    log(f"  {label}: {reps} calls in {t.segments.size} segments, bitwise "
        f"identical")


def shard_apply(t, q, blocks: int = 1, fill: float = float("nan")):
    """The fused apply of tables ``t`` as ``blocks`` lane blocks, one shard
    step launch per step and block, each block on its own replica of y
    (filled with ``fill``: a forward step must read the slices not yet
    written as 0), each step's block entries copied to every replica by
    hand (the all-gather of a mesh).  Returns the replicas."""
    import torch

    from repro_torch.kernels import (hbmc_trisolve_shard_step,
                                     hbmc_trisolve_shard_step_batched)
    s_, r_full = t.n_steps, t.lanes
    r_loc = r_full // blocks
    step = hbmc_trisolve_shard_step_batched if q.dim() == 3 else \
        hbmc_trisolve_shard_step
    shards = [tuple(u[:, i * r_loc:(i + 1) * r_loc].contiguous()
                    for u in (t.cols, t.vals, t.dinv))
              for i in range(blocks)]
    ys = [torch.full((s_ * r_full,) + tuple(q.shape[2:]), fill,
                     dtype=q.dtype, device=q.device) for _ in range(blocks)]
    for g in range(2 * s_):
        dest = (g if g < s_ else 2 * s_ - 1 - g) * r_full
        for i, y in enumerate(ys):
            step(*shards[i], q, y, g, i * r_loc)
        for i, y in enumerate(ys):
            chunk = slice(dest + i * r_loc, dest + (i + 1) * r_loc)
            for other in ys:
                if other is not y:
                    other[chunk] = y[chunk]
    return ys


def check_shard_steps(plan, label: str, seed: int,
                      sizes=(None, 3)) -> None:
    """The shard step (single RHS for ``None`` in ``sizes``, else batched
    at B) over the whole lane range on a NaN-filled y: bitwise its plain
    version and B1's / B3's per-step cut; where the lanes split in two,
    the two lane blocks run in turn with the gather done by hand, each
    replica bitwise B1 / B3 with its segments."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import (hbmc_trisolve_fused,
                                     hbmc_trisolve_fused_batched,
                                     hbmc_trisolve_shard_step_ref)
    t = plan._precond.tables
    dev, dt = plan.device, plan.dtype
    rng = np.random.default_rng(seed)
    split = t.lanes % 2 == 0
    for nb in sizes:
        q = torch.tensor(rng.normal(size=(t.n_steps, t.lanes) + (
            () if nb is None else (nb,))), device=dev).to(dt)
        before = sum(kernels.cuda_launch_counts().values())
        (got,) = shard_apply(t, q)
        launched = sum(kernels.cuda_launch_counts().values()) - before
        y = torch.full_like(got, float("nan"))
        for g in range(2 * t.n_steps):
            hbmc_trisolve_shard_step_ref(t.cols, t.vals, t.dinv, q, y, g, 0)
        b1 = hbmc_trisolve_fused if nb is None else \
            hbmc_trisolve_fused_batched
        cut = b1(t.cols, t.vals, t.dinv, q,
                 segments=np.arange(2 * t.n_steps))
        which = f"shard step on {label}" + ("" if nb is None else
                                             f", B={nb}")
        if dev.type == "cuda" and launched != 2 * t.n_steps:
            raise AssertionError(f"{which}: {launched} CUDA launches for "
                                 f"{2 * t.n_steps} steps")
        if not torch.equal(got, y):
            raise AssertionError(f"{which}: not bitwise its plain version")
        if not torch.equal(got, cut):
            raise AssertionError(f"{which}: not bitwise B1's / B3's "
                                 f"per-step cut")
        if split:
            want = b1(t.cols, t.vals, t.dinv, q, segments=t.segments)
            for rep in shard_apply(t, q, 2):
                if not torch.equal(rep, want):
                    raise AssertionError(f"{which}: a 2-way lane split is "
                                         f"not bitwise B1 / B3")
    widths = [1 if nb is None else nb for nb in sizes]
    log(f"  {label:<28} shard step B={widths}: {2 * t.n_steps} launches "
        f"an apply, bitwise the plain version "
        f"and B1's / B3's per-step cut"
        + ("; a 2-way lane split gathered by hand bitwise B1 / B3"
           if split else f" (R = {t.lanes} odd: no 2-way split)"))


def single_rhs_turns(fn, batched_fn, t, q, reps: int, device,
                     label: str) -> dict[str, float]:
    """B1 (``fn`` on fused tables ``t``) or B5 (on a sweep table), with
    ``batched_fn`` its batched kernel, timed in turns A B C C B A:

    A  ``batched_fn`` at B = 1 with the segments (B3's / B6's per-step
       body);
    B  ``fn`` with the segments (the prefetching single-RHS body);
    C  ``fn`` with one launch per step (``np.arange(G)``, the per-round
       launch pattern).

    All three must give B's bits.  Prints each one's two event times, CUDA
    launches per call and device time per call under the profiler; returns
    the mean event ms of each."""
    import numpy as np
    import torch
    per_step = np.arange(t.cols.shape[0])
    bodies = {
        "A": lambda: batched_fn(t.cols, t.vals, t.dinv, q[..., None],
                                segments=t.segments).reshape(-1),
        "B": lambda: fn(t.cols, t.vals, t.dinv, q, segments=t.segments),
        "C": lambda: fn(t.cols, t.vals, t.dinv, q, segments=per_step),
    }
    want = bodies["B"]()
    for k, f in bodies.items():
        if not torch.equal(f(), want):
            raise AssertionError(f"{label}: body {k} is not bitwise B")
    times = {k: [] for k in bodies}
    for k in list(bodies) + list(reversed(bodies)):
        times[k].append(time_ms(bodies[k], reps, device))
    out = {k: sum(v) / len(v) for k, v in times.items()}
    for k, f in bodies.items():
        log(f"  {label} {k}: {' / '.join(f'{ms:.4f}' for ms in times[k])} "
            f"ms, {cuda_launches_per_call(f)} CUDA launches per call, device "
            f"{fmt_ms(device_ms(f, reps, device))} ms per call under the "
            f"profiler")
    log(f"  {label}: B takes {out['B'] / out['A']:.3f} of A's time and "
        f"{out['B'] / out['C']:.3f} of C's")
    return out


def embedded(plan, rhs):
    """``rhs`` (n[, B]) in the caller's ordering -> the plan's solve layout
    on its device."""
    import numpy as np
    b_bar = np.zeros((plan.n_padded,) + rhs.shape[1:])
    b_bar[plan._perm] = rhs
    return plan._embed(b_bar)


def loop_runner(plan, rhs, batched: bool, k: int | None = None):
    """``run(eager)`` -> (seconds, result) of one warm PCG loop of ``plan``
    on ``rhs`` at ``k`` steps per read (None: the plan's own), the
    device synchronised around it: replayed graphs through the plan's
    cache, or (``eager``) every block run eagerly."""
    from repro_torch.core.iccg import _pcg_batched_device, _pcg_device
    b_dev = embedded(plan, rhs)
    fn, ops = ((_pcg_batched_device, (plan._spmv_batched,
                                      plan._precond.apply_batched))
               if batched else (_pcg_device, (plan._spmv, plan._precond)))

    def run(eager: bool):
        plan._sync()
        t0 = time.perf_counter()
        res = fn(*ops, b_dev, steps_per_read=k,
                 loops=None if eager else plan._pcg_cache, eager=eager)
        plan._sync()
        return time.perf_counter() - t0, res
    return run


def profile_solve(plan, b, b_batched, tag: str = "") -> None:
    """Device time by kernel over one warm single-RHS and one warm batched
    PCG loop, each replayed as graphs (the plan's path) and run eagerly
    block by block (torch.profiler), and the device's busy share of each:
    kernel time over the loop's wall time under the profiler, and over its
    wall time without the profiler (median of 3 loops).  Memory copies are
    counted apart (the flag reads).  The profiler adds host cost per op,
    so the busy share under it is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for label, batched, rhs in ((f"{tag}solve", False, b),
                                (f"{tag}solve_batched "
                                 f"(B={b_batched.shape[1]})", True,
                                 b_batched)):
        run = loop_runner(plan, rhs, batched)
        for eager in (False, True):
            run(eager)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                loop_s, _ = run(eager)
            by_name: dict[str, float] = {}
            spans = []
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    spans.append((e.time_range.start, e.time_range.end,
                                  e.name))
                    by_name[e.name] = by_name.get(e.name, 0.0) + \
                        e.time_range.elapsed_us() / 1e3
            records = len(spans)
            wall = sorted(run(eager)[0] for _ in range(3))[1] * 1e3
            loop_ms = loop_s * 1e3
            how = "eager blocks" if eager else "replayed graphs"
            if not by_name:
                log(f"profile of one {label}, {how}: no device activity "
                    f"recorded (device busy share: not measured); PCG loop "
                    f"{loop_ms:.2f} ms under the profiler, {wall:.2f} ms "
                    f"without")
                continue
            copy_ms = sum(ms for name, ms in by_name.items()
                          if name.startswith("Memcpy"))
            kernel_ms = sum(by_name.values()) - copy_ms
            log(f"profile of one {label}, {how}: device kernels "
                f"{kernel_ms:.2f} ms in {records} device records; the PCG "
                f"loop {loop_ms:.2f} ms under the profiler "
                f"({100 * kernel_ms / loop_ms:.1f}% busy), {wall:.2f} ms "
                f"without it ({100 * kernel_ms / wall:.1f}% busy); memory "
                f"copies {copy_ms:.2f} ms; device ms by kernel:")
            for name, ms in sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:8]:
                log(f"  {ms:9.3f}  {name[:90]}")
            log("  device idle between records, by the record after the "
                "gap: " + "; ".join(f"{ms:.3f} ms in {k} gaps before {name}"
                                    for name, ms, k in
                                    idle_by_next_kernel(spans)))


def idle_by_next_kernel(spans, top: int = 4) -> list[tuple[str, float,
                                                            int]]:
    """Where a device timeline idles: ``spans`` are (start us, end us,
    name) of device records; every gap between the end of all earlier
    records and the next start is charged to the record after it.
    Returns the ``top`` names by idle ms, as (name, ms, gaps)."""
    idle: dict[str, list] = {}
    end = None
    for start, stop, name in sorted(spans):
        if end is not None and start > end:
            got = idle.setdefault(name[:60], [0.0, 0])
            got[0] += (start - end) / 1e3
            got[1] += 1
        end = stop if end is None else max(end, stop)
    return sorted(((n, ms, k) for n, (ms, k) in idle.items()),
                  key=lambda t: -t[1])[:top]


def graph_turns(plan, plan_idx, b, b8, reps: int) -> None:
    """Phase 4: every PCG loop replayed as graphs (B) against the same loop
    run eagerly block by block (A), in turns A B B A at each k in
    ``LOOP_KS``: ms per loop trip (median of ``reps`` loops a turn), the
    capture's own seconds, and the replayed result bitwise the eager
    one."""
    import torch
    for label, pl, batched, rhs in (("round-major", plan, False, b),
                                    ("index", plan_idx, False, b),
                                    (f"round-major B={BATCH}", plan, True,
                                     b8),
                                    (f"index B={BATCH}", plan_idx, True,
                                     b8)):
        for k in LOOP_KS:
            run = loop_runner(pl, rhs, batched, k)
            _, got = run(False)          # captured here unless cached
            _, want = run(True)
            for g, w in zip(got, want):
                if not (g == w if isinstance(w, int) else torch.equal(g, w)):
                    raise AssertionError(f"{label} k={k}: the replayed loop "
                                         f"is not bitwise the eager one")
            trips = got[3] if batched else int(got[1])
            kind = "batched" if batched else "single"
            cap = [lp.capture_seconds for key, lp in pl._pcg_cache.items()
                   if key[0] == kind and key[6] == k
                   and key[7] == (BATCH if batched else None)
                   and key[1:6] == (1e-7, 10_000, False, 1e8, 1000)]
            times = {"A": [], "B": []}
            for turn in "ABBA":
                ms = sorted(run(turn == "A")[0] for _ in range(reps))
                times[turn].append(ms[len(ms) // 2] * 1e3 / max(trips, 1))
            a_ms, b_ms = (sum(v) / 2 for v in (times["A"], times["B"]))
            log(f"PCG loop {label}, k={k:>2}: ms per iteration, eager / "
                f"graph / graph / eager: {times['A'][0]:.4f} / "
                f"{times['B'][0]:.4f} / {times['B'][1]:.4f} / "
                f"{times['A'][1]:.4f}; graph takes {b_ms / a_ms:.3f} of "
                f"eager; {trips} trips, {-(-trips // k)} reads; capture "
                f"{cap[0] if cap else 0.0:.3f} s; bitwise the eager loop")


def graph_cache_phase(plan, a, b, first, plan_kw: dict,
                      on_card: bool) -> None:
    """Phase 3, graphs: the plan keeps one captured graph for the solve's
    signature (none off the card) across a warm solve, which replays from
    the first block and gives the first solve's bits, and across
    ``refactor`` to a perturbed matrix and back, which write the new values
    in place: the perturbed solve converges on the perturbed matrix, the
    solve after the way back gives the first solve's bits.  At a small
    size the refactored solve is bitwise a cold plan's."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core import build_plan
    want = 1 if on_card else 0
    warm = plan.solve(b)
    a2 = (a + 0.37 * sp.diags(a.diagonal())).tocsr()
    t0 = time.perf_counter()
    plan.refactor(a2)
    refactor_s = time.perf_counter() - t0
    moved = plan.solve(b)
    true2 = float(np.linalg.norm(b - a2 @ moved.x) / np.linalg.norm(b))
    plan.refactor(a)
    back = plan.solve(b)
    log(f"graphs: {plan._capture_count} captured for {len(plan._pcg_cache)} "
        f"signature(s) after a warm solve ({warm.result.iterations} it, "
        f"{warm.solve_seconds:.3f} s), refactor to A + 0.37 diag(A) "
        f"({refactor_s:.3f} s; {moved.result.status} in "
        f"{moved.result.iterations} it, true relres {true2:.3e}) and back "
        f"({back.result.iterations} it)")
    for label, rep in (("warm", warm), ("refactored back", back)):
        if (rep.result.iterations != first.result.iterations
                or not np.array_equal(rep.x, first.x)):
            raise AssertionError(f"{label} solve is not bitwise the first")
    if moved.result.status != "CONVERGED" or not true2 < 1e-6:
        raise AssertionError("the refactored solve did not solve the "
                             "refactored matrix")
    if plan._capture_count != want or len(plan._pcg_cache) != 1:
        raise AssertionError(f"{plan._capture_count} graphs captured for "
                             f"{len(plan._pcg_cache)} signatures")
    a_s = thermal2_matrix(48)
    b_s = np.random.default_rng(8).normal(size=a_s.shape[0])
    p_s = build_plan(a_s, **plan_kw)
    p_s.solve(b_s)
    a_s2 = (a_s + 0.37 * sp.diags(a_s.diagonal())).tocsr()
    p_s.refactor(a_s2)
    got = p_s.solve(b_s)
    cold = build_plan(a_s2, **plan_kw).solve(b_s)
    if (p_s._capture_count != want or not np.array_equal(got.x, cold.x)
            or got.result.iterations != cold.result.iterations):
        raise AssertionError("small refactored solve is not bitwise a cold "
                             "plan's, or captured again")
    log(f"graphs: small plan (n={a_s.shape[0]}) refactored, "
        f"{got.result.iterations} it, bitwise a cold plan's solve; "
        f"{p_s._capture_count} graph captured")


def segment_phase(plan, plan_idx, grid: int) -> None:
    """The barrier-free segments of the main plans' tables, recomputed on
    the host and timed: equal to the ones the tables carry, and at the 1M
    plan one per color boundary -- 3 for the fused apply, 2 per sweep."""
    import numpy as np

    from repro_torch.kernels.segments import barrier_segments
    kp = plan_idx._precond.kernel
    got = {}
    for label, tab, fused in (("fused", plan._precond.tables, True),
                              ("index fwd", kp.fwd, False),
                              ("index bwd", kp.bwd, False)):
        cols = tab.cols.cpu().numpy()
        t0 = time.perf_counter()
        seg = barrier_segments(cols, fused)
        sec = time.perf_counter() - t0
        log(f"barrier segments, {label} table {tuple(cols.shape)}: "
            f"{seg.tolist()} in {sec:.3f} s (host, numpy)")
        if not np.array_equal(seg, tab.segments):
            raise AssertionError(f"{label} tables carry {tab.segments}, "
                                 f"recomputed {seg}")
        got[label] = seg.tolist()
    want = {"fused": [0, 16, 48], "index fwd": [0, 16],
            "index bwd": [0, 16]}
    if grid == MAIN_GRID and got != want:
        raise AssertionError(f"segments {got}, expected {want} at the 1M "
                             f"plan")


def cuda_launches_want(on_card: bool, **counts) -> dict:
    """The kernels' CUDA launches of a run that launched only ``counts``
    (none off the card)."""
    want = dict(NO_LAUNCHES)
    if on_card:
        want.update(counts)
    return want


def reset_counts() -> None:
    """Zero the kernels' launch counters, the PCG loops' counters and the
    mesh's all-gather counters."""
    from repro_torch import kernels
    from repro_torch.core import device_loop, mesh
    kernels.reset_launch_counts()
    device_loop.reset_loop_counts()
    mesh.reset_gather_counts()


def loop_blocks(trips: list[int], label: str,
                on_card: bool) -> tuple[int, int]:
    """The PCG loops' blocks since ``reset_counts``, over loop runs of
    ``trips`` trips each: ``ceil(trips / k)`` blocks a run, one flag read
    per block and one before it; on the card every block but a capture's
    eager first one a replay (off it none).  Returns ``(k, blocks)``; a
    block launches k steps' kernels, masked steps included."""
    from repro_torch.core import device_loop
    k = device_loop._STEPS_PER_READ
    loops = device_loop.loop_counts()
    want = sum(-(-t // k) for t in trips)
    log(f"{label}: {loops['blocks']} blocks of k = {k} steps for "
        f"{sum(trips)} trips ({loops['replays']} replayed, "
        f"{loops['captures']} captured), {loops['reads']} flag reads")
    replays = want - loops["captures"] if on_card else 0
    if (loops["blocks"] != want or loops["reads"] != want + len(trips)
            or loops["replays"] != replays):
        raise AssertionError(f"{label}: loop counts {loops}, expected "
                             f"{want} blocks over {len(trips)} runs")
    return k, loops["blocks"]


def solve_batched_phase(plan, a, on_card: bool):
    """Phase 3b: ``plan.solve_batched`` on B = 8 seeded columns."""
    import numpy as np

    from repro_torch import kernels
    n = a.shape[0]
    b8 = np.random.default_rng(11).normal(size=(n, BATCH))
    reset_counts()
    rep = plan.solve_batched(b8)
    counts = kernels.launch_counts()
    cuda_counts = kernels.cuda_launch_counts()
    res = rep.result
    k, blocks = loop_blocks([res.n_steps], "solve_batched", on_card)
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
        want.update(hbmc_trisolve_fused_batched=1 + k * blocks,
                    sell_spmv_batched=k * blocks)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    n_seg = plan._precond.tables.segments.size
    want_cuda = cuda_launches_want(
        on_card, hbmc_trisolve_fused_batched=n_seg * (1 + k * blocks),
        sell_spmv_batched=k * blocks)
    log(f"solve_batched: CUDA launches {cuda_counts} (B3 {n_seg} per "
        f"apply)")
    if cuda_counts != want_cuda:
        raise AssertionError(f"CUDA launches {cuda_counts}, expected "
                             f"{want_cuda}")
    return rep, b8, counts, cuda_counts


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
    reset_counts()
    t0 = time.perf_counter()
    rids = [svc.submit(a, b) for b in bs]
    t1 = time.perf_counter()
    svc.drain()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    cuda_counts = kernels.cuda_launch_counts()
    done = [svc.completed[r] for r in rids]
    steps = sum(e["steps"] for e in svc.dispatch_log)
    # the plan is read only now, after the service has drained
    plan, cache_status = svc.cache.get(a, **plan_kw)
    if cache_status != "hit":
        raise AssertionError(f"service plan not cached ({cache_status})")
    k, blocks = loop_blocks([e["steps"] for e in svc.dispatch_log],
                            "service", on_card)
    if on_card and plan._capture_count != 1:
        raise AssertionError(f"service plan captured {plan._capture_count} "
                             f"graphs for one signature")
    log(f"service: {len(done)} requests in {wall_s:.3f} s wall "
        f"({len(done) / wall_s:.2f} solves/s; plan build included): "
        f"submits {t1 - t0:.3f} s (canonical CSR + fingerprints of the "
        f"matrix, per request), drain {wall_s - (t1 - t0):.3f} s of which "
        f"plan build {plan.timings.total:.3f} s; "
        f"{len(svc.dispatch_log)} dispatches, {steps} slab steps, "
        f"quarantined {svc.n_quarantined}; launches {counts}")
    want = dict(NO_LAUNCHES)
    if on_card:
        want.update(hbmc_trisolve_fused_batched=len(svc.dispatch_log)
                    + k * blocks, sell_spmv_batched=k * blocks)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    n_seg = plan._precond.tables.segments.size
    want_cuda = cuda_launches_want(
        on_card, hbmc_trisolve_fused_batched=n_seg * (
            len(svc.dispatch_log) + k * blocks),
        sell_spmv_batched=k * blocks)
    log(f"service: CUDA launches {cuda_counts} (B3 {n_seg} per apply)")
    if cuda_counts != want_cuda:
        raise AssertionError(f"CUDA launches {cuda_counts}, expected "
                             f"{want_cuda}")
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


def check_sweep_kernels(plan_idx, label: str, seed: int,
                        sizes=BATCH_SIZES) -> dict:
    """B5/B6 vs their plain versions on both sweep tables of an index plan,
    and each B6 column bitwise equal to B5 on that column."""
    import numpy as np
    import torch

    from repro_torch.kernels import (hbmc_trisolve, hbmc_trisolve_batched,
                                     hbmc_trisolve_batched_ref,
                                     hbmc_trisolve_ref)
    dev, dt = plan_idx.device, plan_idx.dtype
    tol = TOL[str(dt)]
    rng = np.random.default_rng(seed)
    worst = {"hbmc_trisolve": 0.0, "hbmc_trisolve_batched": 0.0}
    kp = plan_idx._precond.kernel
    for sweep, t in (("fwd", kp.fwd), ("bwd", kp.bwd)):
        shape = tuple(t.dinv.shape)
        q = torch.tensor(rng.normal(size=shape), device=dev).to(dt)
        y = check_segmented(hbmc_trisolve, hbmc_trisolve_ref, t, q,
                            f"B5 on {label} {sweep}")
        errs = [("hbmc_trisolve", 1,
                 rel_err(y, hbmc_trisolve_ref(t.cols, t.vals, t.dinv, q)))]
        if not torch.isfinite(y).all():
            raise AssertionError(f"non-finite sweep output on {label}")
        for nb in sizes:
            qb = torch.tensor(rng.normal(size=shape + (nb,)),
                              device=dev).to(dt)
            yb = check_segmented(hbmc_trisolve_batched,
                                 hbmc_trisolve_batched_ref, t, qb,
                                 f"B6 on {label} {sweep}, B={nb}")
            errs.append(("hbmc_trisolve_batched", nb, rel_err(
                yb, hbmc_trisolve_batched_ref(t.cols, t.vals, t.dinv, qb))))
            for j in range(nb):
                if not torch.equal(yb[:, j], hbmc_trisolve(
                        t.cols, t.vals, t.dinv, qb[..., j].contiguous(),
                        segments=t.segments)):
                    raise AssertionError(f"B6 column {j} of B={nb} is not "
                                         f"bitwise B5's on {label} {sweep}")
        for name, nb, err in errs:
            if not err <= tol:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {label} {sweep}, B={nb}: "
                                     f"{err:.3e} > {tol:g}")
            worst[name] = max(worst[name], err)
    log(f"  {label:<28} sweeps S={kp.fwd.dinv.shape[0]:>3} "
        f"R={kp.fwd.dinv.shape[1]:>6} K={kp.fwd.vals.shape[-1]}/"
        f"{kp.bwd.vals.shape[-1]}: B5 and B6 B={list(sizes)} in "
        f"{kp.fwd.segments.size}/{kp.bwd.segments.size} segments, bitwise "
        f"the plain version and the per-step cut; every B6 column bitwise "
        f"B5")
    return worst


def sweep_csr(t):
    """The lower-triangular matrix one single sweep solves, in its own
    round-major coordinates, as scipy CSR: lane p's gathered entries and
    1/dinv on its diagonal; 1 on the diagonal of a hole, whose right-hand
    side is 0.  The library yardstick solves with it."""
    import numpy as np
    import scipy.sparse as sp
    cols = t.cols.cpu().numpy().astype(np.int64)
    vals = t.vals.cpu().numpy()
    dinv = t.dinv.cpu().numpy().reshape(-1)
    m = dinv.size
    rows = np.broadcast_to(np.arange(m).reshape(cols.shape[:2] + (1,)),
                           cols.shape)
    keep = cols < m
    diag = np.ones(m)
    live = dinv != 0
    diag[live] = 1.0 / dinv[live]
    a = sp.csr_matrix((np.concatenate([vals[keep], diag]),
                       (np.concatenate([rows[keep], np.arange(m)]),
                        np.concatenate([cols[keep], np.arange(m)]))),
                      shape=(m, m))
    a.sort_indices()
    return a


def library_sweep_ms(tab, q, qb, y, yb, reps: int, device):
    """The library yardstick of B5 / B6: ``torch.triangular_solve`` on the
    sweep's matrix as a sparse CSR tensor (cuSPARSE SpSV, and SpSM for
    (m, B)), held against the kernels' results and timed.  Returns
    ``(ms, ms_batched)``, each None where the installed torch refuses the
    call (the reason is printed).  The port never calls it."""
    import torch
    a = sweep_csr(tab)
    m = a.shape[0]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        warnings.filterwarnings("ignore", ".*triangular_solve.*")
        a_t = torch.sparse_csr_tensor(
            torch.tensor(a.indptr, dtype=torch.int64),
            torch.tensor(a.indices, dtype=torch.int64),
            torch.tensor(a.data), size=a.shape).to(device)
        out = []
        for rhs, want in ((q.reshape(m, 1), y.reshape(m, 1)),
                          (qb.reshape(m, -1), yb)):
            try:
                got = torch.triangular_solve(rhs, a_t, upper=False).solution
            except (RuntimeError, NotImplementedError, TypeError) as e:
                log(f"library sweep yardstick at B={rhs.shape[1]}: none "
                    f"({type(e).__name__}: {str(e).splitlines()[0][:200]})")
                out.append(None)
                continue
            err = rel_err(got, want)
            if not err <= 1e-10:
                raise AssertionError(f"torch.triangular_solve on CSR "
                                     f"disagrees with the sweep kernel at "
                                     f"B={rhs.shape[1]}: {err:.3e}")
            out.append(time_ms(lambda: torch.triangular_solve(
                rhs, a_t, upper=False), reps, device))
    return tuple(out)


def index_phase(plan, a, plan_rm, plan_kw: dict, b, b8, iterations,
                on_card: bool):
    """Phase 3d: the index layout plan ``plan`` on the main matrix ``a``;
    ``plan_rm`` is the round-major plan of the same matrix.  Returns the
    launch counts of the single-RHS and of the batched solve."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import build_plan
    n = a.shape[0]
    dev = plan_rm.device
    reset_counts()
    rep = plan.solve(b)
    counts = kernels.launch_counts()
    cuda_counts = kernels.cuda_launch_counts()
    res = rep.result
    k, blocks = loop_blocks([res.iterations], "index solve", on_card)
    true_relres = float(np.linalg.norm(b - a @ rep.x) / np.linalg.norm(b))
    log(f"index solve: status {res.status}, iterations {res.iterations}, "
        f"relres {res.relres:.3e}, true relres {true_relres:.3e}, "
        f"{rep.solve_seconds:.3f} s; launches {counts}; CUDA launches "
        f"{cuda_counts}")
    if res.status != "CONVERGED":
        raise AssertionError(f"index solve ended {res.status}")
    if iterations is not None and abs(res.iterations - iterations) > \
            ITER_BAND:
        raise AssertionError(f"index solve: {res.iterations} iterations, "
                             f"expected {iterations} +- {ITER_BAND}")
    if not (rep.x.shape == (n,) and np.isfinite(rep.x).all()
            and true_relres < 1e-6):
        raise AssertionError(f"bad index solution: true relres "
                             f"{true_relres:.3e}")
    want = dict(NO_LAUNCHES)
    if on_card:
        want.update(hbmc_trisolve=2 * (1 + k * blocks),
                    sell_spmv=k * blocks)
    if counts != want:
        raise AssertionError(f"index launch counts {counts}, expected "
                             f"{want}")
    kp = plan._precond.kernel
    per_apply = kp.fwd.segments.size + kp.bwd.segments.size   # B5 and B6
    want_cuda = cuda_launches_want(
        on_card, hbmc_trisolve=per_apply * (1 + k * blocks),
        sell_spmv=k * blocks)
    if cuda_counts != want_cuda:
        raise AssertionError(f"index CUDA launches {cuda_counts}, expected "
                             f"{want_cuda}")
    log(f"index solve: B5 {kp.fwd.segments.size} + {kp.bwd.segments.size} "
        f"CUDA launches per apply")

    reset_counts()
    rep_b = plan.solve_batched(b8)
    counts_b = kernels.launch_counts()
    cuda_b = kernels.cuda_launch_counts()
    res_b = rep_b.result
    k, blocks = loop_blocks([res_b.n_steps], "index solve_batched", on_card)
    singles = [plan.solve(b8[:, j]).result.iterations
               for j in range(b8.shape[1])]
    true_b = (np.linalg.norm(b8 - a @ rep_b.x, axis=0)
              / np.linalg.norm(b8, axis=0))
    log(f"index solve_batched B={b8.shape[1]}: statuses "
        f"{res_b.status_names}, iterations {res_b.iterations.tolist()} "
        f"(index plan.solve: {singles}), n_steps {res_b.n_steps}, max true "
        f"relres {true_b.max():.3e}; launches {counts_b}")
    if (res_b.status_names != ["CONVERGED"] * b8.shape[1]
            or res_b.iterations.tolist() != singles
            or not (true_b < 1e-6).all()):
        raise AssertionError("index batched solve disagrees with its "
                             "single-RHS solves")
    want = dict(NO_LAUNCHES)
    if on_card:
        want.update(hbmc_trisolve_batched=2 * (1 + k * blocks),
                    sell_spmv_batched=k * blocks)
    if counts_b != want:
        raise AssertionError(f"index batched launch counts {counts_b}, "
                             f"expected {want}")
    want_cuda = cuda_launches_want(
        on_card, hbmc_trisolve_batched=per_apply * (1 + k * blocks),
        sell_spmv_batched=k * blocks)
    log(f"index solve_batched: CUDA launches {cuda_b} (B6 "
        f"{kp.fwd.segments.size} + {kp.bwd.segments.size} per apply)")
    if cuda_b != want_cuda:
        raise AssertionError(f"index CUDA launches {cuda_b}, expected "
                             f"{want_cuda}")

    # one apply of each layout on the same seeded vector, in HBMC order
    live = ~plan._sysd.drop
    r = np.random.default_rng(13).normal(size=(plan.n_padded, BATCH))
    rm = plan_rm._rm
    z_idx = plan._precond(torch.tensor(r[:, 0], device=dev)).cpu().numpy()
    z_rm = rm.extract(plan_rm._precond(
        torch.tensor(rm.embed(r[:, 0]), device=dev)).cpu().numpy())
    zb_idx = plan._precond.apply_batched(
        torch.tensor(r, device=dev)).cpu().numpy()
    zb_rm = rm.extract(plan_rm._precond.apply_batched(
        torch.tensor(rm.embed(r), device=dev)).cpu().numpy())
    diff = float(np.abs(z_idx[live] - z_rm[live]).max())
    if not (np.array_equal(z_idx[live], z_rm[live])
            and np.array_equal(zb_idx[live], zb_rm[live])):
        raise AssertionError(f"index apply is not bitwise the round-major "
                             f"apply on live entries (max diff {diff:.3e})")
    log(f"index apply (two B5 sweeps) bitwise equal to the round-major "
        f"fused apply (B1) on all {int(live.sum())} live entries, and two "
        f"B6 sweeps to B3 at B={BATCH}")

    a_small = thermal2_matrix(48)
    b_small = np.random.default_rng(8).normal(size=a_small.shape[0])
    kw = {**plan_kw, "layout": "index"}
    r_dev = build_plan(a_small, **kw).solve(b_small)
    r_cpu = build_plan(a_small, **{**kw, "device": "cpu"}).solve(b_small)
    small_err = float(np.abs(r_dev.x - r_cpu.x).max()
                      / np.abs(r_cpu.x).max())
    log(f"small index solve (n={a_small.shape[0]}): "
        f"{r_dev.result.iterations} it vs cpu {r_cpu.result.iterations} it, "
        f"solution rel diff {small_err:.3e}")
    if (r_dev.result.status != "CONVERGED"
            or abs(r_dev.result.iterations - r_cpu.result.iterations) > 1
            or small_err > 1e-6):
        raise AssertionError("small index solve disagrees with the CPU path")
    return counts, counts_b, cuda_counts, cuda_b


def smoother_phase(plan_idx, b, device: str) -> float:
    """Phase 3e: GS / SOR sweeps on the index plan's HBMC-ordered system;
    returns ms per GS sweep on the device."""
    import numpy as np
    import torch

    from repro_torch.core import build_plan
    from repro_torch.core.smoothers import build_gs_smoother, gs_solve
    sysd = plan_idx._sysd
    b_bar = np.zeros(plan_idx.n_padded)
    b_bar[plan_idx._perm] = b
    args = (sysd.a_bar, sysd.fwd_rounds, sysd.bwd_rounds)
    sweep_ms = 0.0
    for omega in (1.0, 1.5):
        sm = build_gs_smoother(*args, drop_mask=sysd.drop, omega=omega,
                               device=device)
        t0 = time.perf_counter()
        x, hist = gs_solve(sm, b_bar, sweeps=SMOOTHER_SWEEPS,
                           a_bar=sysd.a_bar)
        wall = time.perf_counter() - t0
        log(f"smoother omega={omega}: {len(hist)} sweeps in {wall:.3f} s "
            f"(host residuals included), relres {hist[0]:.6e} -> "
            f"{hist[-1]:.6e}")
        if not (len(hist) == SMOOTHER_SWEEPS and np.isfinite(hist).all()
                and np.isfinite(x).all() and (np.diff(hist) < 0).all()):
            raise AssertionError(f"smoother omega={omega}: residuals not "
                                 f"finite and decreasing: {hist}")
        if omega == 1.0:
            bd = torch.tensor(b_bar, device=sm.device)
            xd = torch.zeros_like(bd)
            sweep_ms = time_ms(lambda: sm.sweep(bd, xd), 10, sm.device)
    a_small = thermal2_matrix(40)
    p_small = build_plan(a_small, method="hbmc", block_size=16, w=8,
                         layout="index", device="cpu")
    ss = p_small._sysd
    bs = np.zeros(p_small.n_padded)
    bs[p_small._perm] = np.random.default_rng(14).normal(
        size=a_small.shape[0])
    hists = [gs_solve(build_gs_smoother(ss.a_bar, ss.fwd_rounds,
                                        ss.bwd_rounds, drop_mask=ss.drop,
                                        omega=1.5, device=dev), bs,
                      sweeps=10, a_bar=ss.a_bar)[1]
             for dev in (device, "cpu")]
    rel = float(np.max(np.abs(np.subtract(*hists)) / np.abs(hists[1])))
    log(f"small smoother (n={a_small.shape[0]}): {device} residual history "
        f"vs cpu, max rel diff {rel:.3e}")
    if not rel <= 1e-12:
        raise AssertionError("small smoother history disagrees with the CPU")
    return sweep_ms


def analysis_phase(a, plan_kw: dict, on_card: bool) -> None:
    """Phase 3g: ``repro_torch.analysis`` on the 1M plan.  The validation
    seconds of each mode, timed as ``validate_plan`` on one plan built with
    ``validate="off"`` (in the order cheap, full, deep: "full" computes the
    fused table's segments, which "deep" then finds) and as the share of
    the build (``plan.timings.pack``) with ``build_plan(validate=m)``; the
    kernel checks, the traffic terms with the bytes the wrappers saw, the
    op budgets and the dtype flow of the eager apply, SpMV and first block;
    a doctored cut of the fused table (its middle start removed), which
    ``check_segments`` must witness and which is never launched; a service
    run with ``PlanCache(validate="full")`` admission; and the CLI in a
    subprocess.  Every finding list must be empty."""

    import numpy as np
    import torch

    from repro_torch.analysis import (FULL_PALLAS_ITERATION, PALLAS_SPMV,
                                      PRECONDITIONED_ITERATION,
                                      ROUND_MAJOR_APPLY,
                                      check_plan_dtype_flow,
                                      check_plan_kernels, check_segments,
                                      lint, plan_launches, traffic_report,
                                      validate_plan)
    from repro_torch.analysis.dtype_flow import nonzero_rhs
    from repro_torch.analysis.traffic import compare_traffic
    from repro_torch.core import build_plan, pcg_iteration
    from repro_torch.serve import PlanCache, SolverService, WallClock

    def expect_clean(what: str, found: list) -> None:
        log(f"  {what}: {[str(v) for v in found]}")
        if found:
            raise AssertionError(f"{what}: {found}")

    t0 = time.perf_counter()
    plan = build_plan(a, **plan_kw)
    off_s = time.perf_counter() - t0
    log(f"build_plan(validate='off') {off_s:.3f} s (pack "
        f"{plan.timings.pack:.3f} s)")
    for mode in ("cheap", "full", "deep"):
        t0 = time.perf_counter()
        found = validate_plan(plan, mode)
        log(f"validate_plan(plan, {mode!r}): "
            f"{time.perf_counter() - t0:.3f} s")
        expect_clean(f"validate {mode}", found)
    t = plan._precond.tables
    cols = t.cols.cpu().numpy()
    t0 = time.perf_counter()
    found = check_segments(cols, t.segments, True, where="segments/fused")
    log(f"check_segments on the {tuple(cols.shape)} table, segments "
        f"{t.segments.tolist()}: {time.perf_counter() - t0:.3f} s")
    expect_clean("check_segments", found)
    for mode in ("cheap", "full", "deep"):
        t0 = time.perf_counter()
        p = build_plan(a, validate=mode, **plan_kw)
        log(f"build_plan(validate={mode!r}) {time.perf_counter() - t0:.3f} "
            f"s: pack {p.timings.pack:.3f} s, off's {plan.timings.pack:.3f}"
            f" (validation is in pack)")
        del p

    # the doctored cut: the fused table's middle start removed
    seg = t.segments
    coarse = np.delete(seg, seg.size // 2)
    found = check_segments(cols, coarse, True, where="segments/fused")
    log(f"doctored cut {coarse.tolist()} (of {seg.tolist()}): "
        f"{len(found)} witness(es), first {found[0] if found else None}")
    if not found or {v.kind for v in found} != {"segment-race"}:
        raise AssertionError(f"the doctored cut was not witnessed: {found}")

    expect_clean("check_plan_kernels B=1", check_plan_kernels(plan))
    expect_clean(f"check_plan_kernels B={BATCH}",
                 check_plan_kernels(plan, BATCH))
    log(f"  launches B=1 {plan_launches(plan)}; B={BATCH} "
        f"{plan_launches(plan, BATCH)}")
    rep = traffic_report(plan)
    for term in rep.terms + rep.kernel_terms:
        log(f"  traffic {term.name}: static {term.static_bytes:.0f} B, "
            f"measured {term.measured_bytes} ({term.detail})")
    log(f"  iteration {rep.iteration_bytes / 1e6:.1f} MB, "
        f"{rep.arithmetic_intensity:.3f} flop/B")
    expect_clean("traffic", compare_traffic(rep.terms + rep.kernel_terms))
    if [t_.name for t_ in rep.kernel_terms] != ["kernel/apply",
                                                "kernel/spmv"]:
        raise AssertionError(f"kernel terms {rep.kernel_terms}")
    q = nonzero_rhs(plan)
    steps = 2 * plan.n_rounds
    step = pcg_iteration(plan._spmv, plan._precond)
    args = (torch.zeros_like(q), q, q.clone(),
            torch.ones((), dtype=plan.dtype, device=plan.device))
    expect_clean("lint apply", lint(plan._precond, q,
                                    budget=ROUND_MAJOR_APPLY))
    expect_clean("lint SpMV", lint(plan._spmv, q, budget=PALLAS_SPMV))
    for budget in (FULL_PALLAS_ITERATION, PRECONDITIONED_ITERATION):
        expect_clean(f"lint iteration {budget.name}",
                     lint(step, *args, budget=budget, steps=steps))
    t0 = time.perf_counter()
    found = check_plan_dtype_flow(plan)
    log(f"  dtype flow of 7 paths: {time.perf_counter() - t0:.3f} s")
    expect_clean("dtype flow", found)
    del plan

    # admission: a second service run, PlanCache(validate="full")
    rng = np.random.default_rng(13)
    cache = PlanCache(validate="full")
    svc = SolverService(cache=cache, slab_width=BATCH, quantum=SERVE_QUANTUM,
                        clock=WallClock(), **plan_kw)
    t0 = time.perf_counter()
    rids = [svc.submit(a, rng.normal(size=a.shape[0]))
            for _ in range(BATCH)]
    svc.drain()
    wall = time.perf_counter() - t0
    statuses = {svc.completed[r].status for r in rids}
    plan, _ = cache.get(a, **plan_kw)
    log(f"service with PlanCache(validate='full'): {len(rids)} requests in "
        f"{wall:.3f} s, plan build {plan.timings.total:.3f} s, admission "
        f"{cache.stats.admission_seconds:.3f} s; statuses {statuses}")
    if statuses != {"CONVERGED"} or cache.stats.misses != 1:
        raise AssertionError(f"admitted service run: {statuses}, "
                             f"{cache.stats}")
    del plan, svc, cache

    cmd = [sys.executable, "-m", "repro_torch.analysis", "--problems",
           "laplace2d,thermal2", "--scale", "tiny", "--validate", "deep",
           "--dtype-flow", "--contracts", "--traffic", "--device",
           plan_kw["device"]]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=600)
    log(f"CLI {' '.join(cmd[1:])}: exit {out.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{out.stdout.strip().splitlines()[-1:]}")
    if out.returncode != 0:
        raise AssertionError(f"analysis CLI failed:\n{out.stdout}\n"
                             f"{out.stderr}")


def mesh_phase(a, plan_kw: dict, b, b8, iterations, on_card: bool,
               reps: int) -> list[dict]:
    """Phase 3f: the mesh path at world size 1 (NCCL on the card, gloo on
    the CPU): ``build_plan(mesh=..., lane_multiple=4)`` on the main
    matrix, ``solve`` and ``solve_batched`` bitwise the single-device plan
    with the same lane multiple, with the launches and all-gathers of the
    mesh path and none of B1 / B3; ms per iteration, whether the loops were
    captured, a ``refactor`` round trip; then the shard steps' and
    ``sell_spmv_block``'s times.  Returns their rows of the kernels line."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import build_plan
    dev_type = "cuda" if on_card else "cpu"
    kw = dict(plan_kw, lane_multiple=MESH_LANE_MULTIPLE)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if on_card else "gloo",
                                init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh(dev_type, (1,), mesh_dim_names=("data",))
            log(f"process group {dist.get_backend()}, world size "
                f"{dist.get_world_size()}; mesh {mesh}")
            t0 = time.perf_counter()
            plan = build_plan(a, mesh=mesh, **kw)
            setup_s = time.perf_counter() - t0
            ref = build_plan(a, **kw)
            t = plan._precond.tables
            log(f"mesh plan: setup {setup_s:.3f} s, lanes "
                f"{plan._precond.lanes} (lane_multiple "
                f"{plan.lane_multiple}), this rank's tables "
                f"{tuple(t.cols.shape)}, SELL block "
                f"{tuple(plan._spmv_vals.shape)}")
            launched = _mesh_solves(plan, ref, a, b, b8, iterations,
                                    on_card, reps)
            profile_solve(plan, b, b8, tag="mesh ")
            rows = _mesh_kernel_times(plan, launched, reps)
            mesh_analysis(plan)
            mesh_solver_step(mesh, dev_type, reps)
        finally:
            dist.destroy_process_group()
    log(f"process group destroyed: initialized={dist.is_initialized()}")
    return rows


def mesh_analysis(plan) -> None:
    """Phase 3g on the mesh of 3f: the collective structure of the mesh
    plan (2S all-gathers an apply, one a SpMV, no all-reduce in a solve)
    and its kernel checks (the shard step on the rank's lane block)."""
    from repro_torch.analysis import (check_plan_collectives,
                                      check_plan_kernels, plan_launches,
                                      validate_plan)
    t0 = time.perf_counter()
    found = check_plan_collectives(plan)
    found += check_plan_kernels(plan) + check_plan_kernels(plan, BATCH)
    log(f"3g mesh: check_plan_collectives + check_plan_kernels "
        f"{time.perf_counter() - t0:.3f} s: {[str(v) for v in found]}; "
        f"launches {plan_launches(plan)}")
    if found:
        raise AssertionError(f"mesh plan analysis: {found}")
    # the built mesh plan keeps its lane block only: "full" gathers the
    # whole tables over the mesh axis and proves them
    t0 = time.perf_counter()
    found = validate_plan(plan, "full")
    log(f"3f validate_plan(built mesh plan, 'full') "
        f"{time.perf_counter() - t0:.3f} s: {[str(v) for v in found]}")
    if found:
        raise AssertionError(f"mesh plan validation: {found}")


def mesh_solver_step(mesh, dev_type: str, reps: int) -> None:
    """Phase 3f: ``partition.lower_solver_step`` on the index tables of a
    small plan (``laplace_2d(32, 32)``, HBMC block 8, w 4, ELL: the
    reference's ``test_solver_step_lowers_on_mesh`` system).  Its first
    call runs eagerly and captures the iteration; its replays must be
    bitwise the eager iteration, five iterations in a row, each replay
    counting its 2S sweep all-gathers and one SpMV all-gather.  Prints the
    counts and the replayed and eager ms per iteration."""
    import numpy as np
    import torch

    from repro_torch.core import (DeviceTables, backward_solve,
                                  block_multicolor_ordering, forward_solve,
                                  hbmc_from_bmc, ic0, pack_factor_hbmc,
                                  pad_system_hbmc)
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core.matrices import laplace_2d
    from repro_torch.core.partition import lower_solver_step
    from repro_torch.core.sell import pack_ell
    dev = torch.device(dev_type)
    a = laplace_2d(32, 32)
    hb = hbmc_from_bmc(block_multicolor_ordering(a, 8), 4)
    a_hb, _ = pad_system_hbmc(a, None, hb)
    fwd_h, bwd_h = pack_factor_hbmc(ic0(a_hb), hb)
    fwd, bwd = (DeviceTables.from_host(t, device=dev) for t in (fwd_h,
                                                                 bwd_h))
    cols, vals = (torch.tensor(v, device=dev) for v in pack_ell(a_hb))
    step = lower_solver_step(fwd, bwd, cols, vals, mesh)
    r = torch.tensor(np.random.default_rng(5).normal(size=a_hb.shape[0]),
                     device=dev)
    z = backward_solve(bwd, forward_solve(fwd, r))
    state = (torch.zeros_like(r), r, z, torch.dot(r, z))
    # the first call runs eagerly and captures; the next five replay
    for i in range(6):
        want = step.eager(*state)
        mesh_mod.reset_gather_counts()
        got = step.step(*state)
        gathers = mesh_mod.gather_counts()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"lower_solver_step: call {i} is not "
                                 f"bitwise the eager iteration")
        state = want
    want_gathers = {"trisolve": step.sweep_steps, "spmv": 1}
    captured = step.graph is not None
    if gathers != want_gathers or captured != (dev.type == "cuda"):
        raise AssertionError(f"lower_solver_step: graph {captured}, "
                             f"all-gathers per replay {gathers}, expected "
                             f"{want_gathers}")
    replay_ms = time_ms(lambda: step.step(*state), reps, dev)
    eager_ms = time_ms(lambda: step.eager(*state), reps, dev)
    log(f"3f lower_solver_step on laplace_2d(32, 32) index tables "
        f"{tuple(fwd.cols.shape)} / {tuple(bwd.cols.shape)}, ELL "
        f"{tuple(cols.shape)}: sweep steps per apply {step.sweep_steps}, "
        f"all-gathers per iteration {step.gathers_per_iteration} (a "
        f"replay counted {gathers}), graph: {str(captured).lower()}; five "
        f"replays bitwise the eager iteration; ms per iteration replayed "
        f"{replay_ms:.4f}, eager {eager_ms:.4f}")



def _mesh_solves(plan, ref, a, b, b8, iterations, on_card: bool,
                 reps: int) -> dict:
    """Phase 3f's solves; returns the launch counts of the kernels line."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch import kernels
    from repro_torch.core import device_loop, mesh as mesh_mod
    n_steps = 2 * plan.n_rounds
    reset_counts()
    rep = plan.solve(b)
    counts, cuda_counts = kernels.launch_counts(), kernels.cuda_launch_counts()
    gathers = mesh_mod.gather_counts()
    res = rep.result
    k, blocks = loop_blocks([res.iterations], "mesh solve", on_card)
    captured = device_loop.loop_counts()["captures"] == 1
    true_relres = float(np.linalg.norm(b - a @ rep.x) / np.linalg.norm(b))
    want = ref.solve(b)
    log(f"mesh solve: status {res.status}, iterations {res.iterations} "
        f"(single-device plan, lane_multiple {ref.lane_multiple}: "
        f"{want.result.iterations}), true relres {true_relres:.3e}, "
        f"{rep.solve_seconds:.3f} s; graph: {str(captured).lower()} "
        f"({plan._capture_count} captured); launches {counts}; CUDA "
        f"launches {cuda_counts}; all-gathers {gathers}")
    if res.status != "CONVERGED" or not true_relres < 1e-6:
        raise AssertionError(f"mesh solve ended {res.status}, true relres "
                             f"{true_relres:.3e}")
    if iterations is not None and abs(res.iterations - iterations) > \
            ITER_BAND:
        raise AssertionError(f"mesh solve: {res.iterations} iterations")
    if (res.iterations != want.result.iterations
            or not np.array_equal(rep.x, want.x)):
        raise AssertionError("mesh solve is not bitwise the single-device "
                             "plan's")
    applies = 1 + k * blocks
    want_counts = cuda_launches_want(
        on_card, hbmc_trisolve_shard_step=n_steps * applies,
        sell_spmv=k * blocks, sell_spmv_block=k * blocks)
    if counts != want_counts or cuda_counts != want_counts:
        raise AssertionError(f"mesh solve launches {counts} / CUDA "
                             f"{cuda_counts}, expected {want_counts}")
    if gathers != {"trisolve": n_steps * applies, "spmv": k * blocks}:
        raise AssertionError(f"mesh solve all-gathers {gathers}")
    if on_card and not captured:
        raise AssertionError("the mesh loop was not captured")
    single_rows = dict(counts=counts, cuda=cuda_counts)

    reset_counts()
    rep_b = plan.solve_batched(b8)
    counts_b, cuda_b = kernels.launch_counts(), kernels.cuda_launch_counts()
    gathers_b = mesh_mod.gather_counts()
    res_b = rep_b.result
    k, blocks_b = loop_blocks([res_b.n_steps], "mesh solve_batched", on_card)
    want_b = ref.solve_batched(b8)
    singles = [plan.solve(b8[:, j]).result.iterations
               for j in range(b8.shape[1])]
    log(f"mesh solve_batched B={b8.shape[1]}: statuses "
        f"{res_b.status_names}, iterations {res_b.iterations.tolist()} "
        f"(mesh plan.solve: {singles}), {rep_b.solve_seconds:.3f} s; "
        f"launches {counts_b}; all-gathers {gathers_b}")
    if (res_b.status_names != ["CONVERGED"] * b8.shape[1]
            or res_b.iterations.tolist() != singles
            or not np.array_equal(rep_b.x, want_b.x)
            or not np.array_equal(res_b.iterations,
                                  want_b.result.iterations)):
        raise AssertionError("mesh solve_batched: not every column at its "
                             "single-RHS count, or not bitwise the "
                             "single-device plan")
    applies_b = 1 + k * blocks_b
    want_b_counts = cuda_launches_want(
        on_card, hbmc_trisolve_shard_step_batched=n_steps * applies_b,
        sell_spmv_batched=k * blocks_b, sell_spmv_block=k * blocks_b)
    if counts_b != want_b_counts or cuda_b != want_b_counts:
        raise AssertionError(f"mesh solve_batched launches {counts_b} / "
                             f"CUDA {cuda_b}, expected {want_b_counts}")
    if gathers_b != {"trisolve": n_steps * applies_b, "spmv": k * blocks_b}:
        raise AssertionError(f"mesh solve_batched all-gathers {gathers_b}")

    iter_ms = loop_ms(plan.solve, b, reps)
    iter_b_ms = loop_ms(plan.solve_batched, b8, max(reps // 2, 1))
    iter_ref_ms = loop_ms(ref.solve, b, reps)
    log(f"mesh PCG iteration: {spread(iter_ms)} ms; single-device plan "
        f"(lane_multiple {ref.lane_multiple}) in turn: "
        f"{spread(iter_ref_ms)} ms")
    log(f"mesh batched PCG iteration, B={b8.shape[1]}: {spread(iter_b_ms)}"
        f" ms")
    a2 = (a + 0.37 * sp.diags(a.diagonal())).tocsr()
    captures = plan._capture_count
    t0 = time.perf_counter()
    plan.refactor(a2)
    refactor_s = time.perf_counter() - t0
    moved = plan.solve(b)
    plan.refactor(a)
    back = plan.solve(b)
    true2 = float(np.linalg.norm(b - a2 @ moved.x) / np.linalg.norm(b))
    log(f"mesh refactor to A + 0.37 diag(A) ({refactor_s:.3f} s; "
        f"{moved.result.status} in {moved.result.iterations} it, true "
        f"relres {true2:.3e}) and back ({back.result.iterations} it, bitwise "
        f"the first solve: {np.array_equal(back.x, rep.x)}); captures "
        f"{captures} -> {plan._capture_count}")
    if (moved.result.status != "CONVERGED" or not true2 < 1e-6
            or not np.array_equal(back.x, rep.x)
            or plan._capture_count != captures):
        raise AssertionError("mesh refactor round trip failed")
    return dict(single=single_rows, batched=dict(counts=counts_b,
                                                 cuda=cuda_b))


def _mesh_kernel_times(plan, launched: dict, reps: int) -> list[dict]:
    """The shard steps (one apply: 2S launches, no collective) and
    ``sell_spmv_block`` on this rank's blocks at the mesh plan's shapes,
    each against its plain version, bound and (for the SpMV) the cuSPARSE
    product of the same rows; the mesh apply (shard steps and all-gathers)
    beside them.  Returns their rows of the kernels line, with the
    launches of the mesh solves (``launched``)."""
    import warnings

    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.analysis.traffic import bound, spmv_bytes
    from repro_torch.core.mesh import axis_group
    from repro_torch.core.sell import permute_round_major
    from repro_torch.kernels import (hbmc_trisolve_shard_step,
                                     hbmc_trisolve_shard_step_batched,
                                     hbmc_trisolve_shard_step_ref,
                                     sell_spmv_block, sell_spmv_ref)
    t, pre = plan._precond.tables, plan._precond
    dev, dt = plan.device, plan.dtype
    _, size, rank = axis_group(plan.mesh, plan.mesh_axis)
    lane0 = rank * t.lanes
    s2 = 2 * t.n_steps
    rng = np.random.default_rng(17)
    rows = []
    for name, fn, nb in (("hbmc_trisolve_shard_step",
                          hbmc_trisolve_shard_step, None),
                         ("hbmc_trisolve_shard_step_batched",
                          hbmc_trisolve_shard_step_batched, BATCH)):
        tail = () if nb is None else (nb,)
        q = torch.tensor(rng.normal(size=(t.n_steps, pre.lanes) + tail),
                         device=dev).to(dt)

        def apply(step, y, q=q):
            def run_steps():
                for g in range(s2):
                    step(t.cols, t.vals, t.dinv, q, y, g, lane0)
                return y
            return run_steps

        y_k = torch.full((pre.m,) + tail, float("nan"), dtype=dt, device=dev)
        y_p = torch.full_like(y_k, float("nan"))
        got, want = apply(fn, y_k)(), apply(hbmc_trisolve_shard_step_ref,
                                            y_p)()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bitwise its plain version at "
                                 f"the mesh plan's shapes")
        err = float((got - want).abs().max())
        # as the mesh loop runs them: one CUDA graph of the 2S launches,
        # replayed; and issued from the host, with their device time
        ms = graph_ms(apply(fn, y_k), reps, dev)
        host_ms = time_ms(apply(fn, y_k), reps, dev)
        dev_ms = device_ms(apply(fn, y_k), reps, dev)
        plain_ms = time_ms(apply(hbmc_trisolve_shard_step_ref, y_p),
                           max(reps // 5, 1), dev)
        def mesh_apply(q=q, nb=nb, tail=tail):
            return (pre.apply_batched if nb else pre)(
                q.reshape((pre.m,) + tail))

        mesh_ms = time_ms(mesh_apply, reps, dev)
        mesh_graph_ms = graph_ms(mesh_apply, reps, dev)
        # this rank's tables once, its lanes of q once, its lanes of y
        # written once
        n_bytes = (t.cols.numel() * t.cols.element_size()
                   + t.vals.numel() * t.vals.element_size()
                   + t.dinv.numel() * t.dinv.element_size()
                   + 2 * q.numel() // size * q.element_size())
        bnd, by = bound(n_bytes, (2 * t.vals.numel() + 2 * t.dinv.numel())
                        * (nb or 1), dt)
        log(f"{name} (B={nb or 1}), one apply of {s2} launches on tables "
            f"{tuple(t.cols.shape)}: kernel {ms:.4f} ms as a replayed graph "
            f"({ms / s2 * 1e3:.2f} us a step), {host_ms:.4f} issued from "
            f"the host (device {fmt_ms(dev_ms)} under the profiler), plain "
            f"{plain_ms:.4f}, bound {bnd:.4f} ({by}, {n_bytes / 1e6:.1f} "
            f"MB); the mesh apply with its {s2} all-gathers: "
            f"{mesh_graph_ms:.4f} ms as a replayed graph, {mesh_ms:.4f} "
            f"issued from the host")
        which = "single" if nb is None else "batched"
        rows.append(kernel_row(name, launched[which]["counts"][name],
                               launched[which]["cuda"][name], err, ms,
                               plain_ms, bnd, by, None))
    sv, sc = plan._spmv_vals, plan._spmv_cols
    x = torch.tensor(rng.normal(size=pre.m), device=dev).to(dt)
    y = sell_spmv_block(sv, sc, x)
    y_ref = sell_spmv_ref(sv, sc, x)
    err = float((y - y_ref).abs().max())
    if not rel_err(y, y_ref) <= TOL[str(dt)]:
        raise AssertionError(f"sell_spmv_block disagrees with its plain "
                             f"version: {rel_err(y, y_ref):.3e}")
    ms = time_ms(lambda: sell_spmv_block(sv, sc, x), 4 * reps, dev)
    plain_ms = time_ms(lambda: sell_spmv_ref(sv, sc, x), reps, dev)
    # cuSPARSE on this rank's rows of the round-major matrix (rows past n
    # are the zero slices' padding)
    n_rows = sv.shape[0] * sv.shape[2]
    lo, n = rank * n_rows, plan._spmv_n
    a_rm = sp.csr_matrix(permute_round_major(plan._sysd.a_bar,
                                             plan._rm))[lo:min(lo + n_rows,
                                                                n)]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        a_lib = torch.sparse_csr_tensor(
            torch.tensor(a_rm.indptr, dtype=torch.int64),
            torch.tensor(a_rm.indices, dtype=torch.int64),
            torch.tensor(a_rm.data), size=(a_rm.shape[0], pre.m)).to(dev)
    lib_err = rel_err(y[:a_rm.shape[0]], torch.mv(a_lib, x))
    if not lib_err <= 1e-12:
        raise AssertionError(f"sell_spmv_block disagrees with torch.mv on "
                             f"CSR: {lib_err:.3e}")
    lib_ms = time_ms(lambda: torch.mv(a_lib, x), 4 * reps, dev)
    bnd, by = bound(spmv_bytes(sv, sc, x), 2 * sv.numel(), dt)
    log(f"sell_spmv_block on slices {tuple(sv.shape)} of this rank: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f}, bound {bnd:.4f} ({by}), "
        f"torch.mv CSR {lib_ms:.4f}")
    rows.append(kernel_row("sell_spmv_block",
                           launched["single"]["counts"]["sell_spmv_block"],
                           launched["single"]["cuda"]["sell_spmv_block"],
                           err, ms, plain_ms, bnd, by, lib_ms))
    return rows


def graph_ms(fn, reps: int, device) -> float:
    """Mean ms per replay of one CUDA graph of ``fn`` (captured after a
    warm-up call), with CUDA events; ``time_ms`` of ``fn`` off the card."""
    import torch
    if device.type != "cuda":
        return time_ms(fn, reps, device)
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps, device)


#: phase 5: each twin of a solver example, its arguments, and the kernels
#: its run on the card must launch
EXAMPLES = (
    ("quickstart", (), ("hbmc_trisolve_fused", "sell_spmv",
                        "hbmc_trisolve_fused_batched", "sell_spmv_batched")),
    ("timestepping", (), ("hbmc_trisolve_fused", "sell_spmv")),
    ("serve_solver", (), ("hbmc_trisolve_fused_batched",
                          "sell_spmv_batched")),
    ("rnn_as_trisolve", (), ()),
    ("iccg_fem", ("--scale", "small"), ("hbmc_trisolve_fused", "sell_spmv")),
)


def example_counts(name: str, got: dict):
    """What must not depend on the device in a twin's result: iteration
    counts, colors, rounds, occupancy, statuses, cache statistics."""
    if name == "quickstart":
        return ([(got[m]["iterations"], got[m]["n_colors"],
                  got[m]["n_rounds"], got[m]["lane_occupancy"])
                 for m in ("mc", "bmc", "hbmc")], got["plain"]["iterations"],
                got["batched"]["iterations"].tolist(),
                got["batched"]["n_steps"])
    if name == "timestepping":
        return got["iterations"]
    if name == "serve_solver":
        return got["steps"], got["hits"], got["misses"], got["refactors"]
    if name == "rnn_as_trisolve":
        return got["err_hbmc"] < 1e-12, got["err_scan"] < 1e-12
    return [(r["solver"], r["iterations"], r["status"]) for r in got["rows"]]


def examples_phase(device: str, bench_scale: str) -> None:
    """Phase 5: the twins of the solver examples (``repro_torch.examples``).
    Each runs on the CPU (its output discarded) and on ``device``; the two
    runs' counts must be equal and the card's run must launch the twin's
    kernels.  Then ``iccg_fem --scale bench_scale`` for each paper dataset:
    every row CONVERGED with true relres < 1e-6 on the host; each row's
    ``solve_iccg`` also solves a second time on the same plan (the warm
    solve, bitwise the first), so a row has its cold and warm seconds."""
    import contextlib
    import importlib
    import io

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import (PAPER_PROBLEMS, build_plan,
                                  paper_problem)
    twins = {name: importlib.import_module(f"repro_torch.examples.{name}")
             for name, _, _ in EXAMPLES}
    for name, argv, used in EXAMPLES:
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = twins[name].main(["--device", "cpu", *argv])
        log(f"-- 5. {name} {' '.join(argv)} on {device}")
        reset_counts()
        t0 = time.perf_counter()
        got = twins[name].main(["--device", device, *argv])
        secs = time.perf_counter() - t0
        launched = kernels.launch_counts()
        want, have = example_counts(name, cpu), example_counts(name, got)
        log(f"5. {name}: {secs:.3f} s on {device}; counts {have} (CPU: "
            f"{'equal' if have == want else want}); launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        if have != want:
            raise AssertionError(f"{name}: counts on {device} {have}, on "
                                 f"the CPU {want}")
        if device == "cuda" and not all(launched[k] for k in used):
            raise AssertionError(f"{name}: launched {launched}, expected "
                                 f"each of {used}")

    fem = twins["iccg_fem"]
    real_solve = fem.solve_iccg
    warm = []

    def solve_twice(a, b, rtol, **knobs):
        plan = build_plan(a, **knobs)
        rep = plan.solve(b, rtol=rtol)
        rep.setup_seconds += plan.timings.total
        again = plan.solve(b, rtol=rtol)
        if again.result.iterations != rep.result.iterations or \
                not np.array_equal(again.x, rep.x):
            raise AssertionError("a warm solve is not the cold one")
        warm.append(again.solve_seconds)
        return rep

    card = card_line() if device == "cuda" else "CPU"
    fem.solve_iccg = solve_twice
    try:
        for ds in PAPER_PROBLEMS:
            warm.clear()
            reset_counts()
            got = fem.main(["--device", device, "--scale", bench_scale,
                            "--dataset", ds])
            launched = kernels.launch_counts()
            a, _ = paper_problem(ds, scale=bench_scale)
            b = np.random.default_rng(0).normal(size=a.shape[0])
            its = {}
            for row, warm_s in zip(got["rows"], warm, strict=True):
                relres = float(np.linalg.norm(b - a @ row["x"])
                               / np.linalg.norm(b))
                its[row["solver"]] = row["iterations"]
                log(f"5. iccg_fem {ds} {bench_scale} n={a.shape[0]} "
                    f"{row['solver']}: {row['status']}, {row['iterations']} "
                    f"iterations, setup {row['setup_s']:.3f} s, solve "
                    f"{row['solve_s']:.4f} s cold, {warm_s * 1e3:.3f} ms "
                    f"warm ({warm_s * 1e3 / max(row['iterations'], 1):.4f} "
                    f"ms per iteration), true relres {relres:.3e} [{card}]")
                if row["status"] != "CONVERGED" or not relres < 1e-6:
                    raise AssertionError(f"iccg_fem {ds} {row['solver']}: "
                                         f"{row['status']}, true relres "
                                         f"{relres:.3e}")
            same = its["bmc/ell"] == its["hbmc/ell"]
            log(f"5. iccg_fem {ds}: bmc/ell {its['bmc/ell']} and hbmc/ell "
                f"{its['hbmc/ell']} iterations ("
                f"{'equal' if same else 'not equal'}); launches "
                f"{ {k: v for k, v in launched.items() if v} }")
            if device == "cuda" and not (launched["hbmc_trisolve_fused"]
                                         and launched["sell_spmv"]):
                raise AssertionError(f"iccg_fem {ds}: launched {launched}")
    finally:
        fem.solve_iccg = real_solve


# ---------------------------------------------------------------------------
# phase 6: LM serving
# ---------------------------------------------------------------------------

#: 6a: every smoke config, card against CPU (batch, prompt, new tokens)
LM_SMOKE = (2, 20, 6)
#: 6b: mamba2-130m at its full config, f32 (a 256-token chunk and a padded
#: one)
LM_MAMBA = ("mamba2-130m", 2, 300, 16)
#: 6c: qwen2.5-3b at its full config, bf16 (the 1,536-token prompt is two
#: query chunks of flash_core: q_chunk 1024)
LM_QWEN = ("qwen2.5-3b", 4, 1536, 64)
#: 6c: the process states the decode chain is timed in, in turns, in the
#: process after phases 1-5 and in a new process that holds only the model
GC_STATES = ("on", "off", "on")
NEW_PROCESS_STATES = ("on", "frozen", "off", "trimmed", "profiled", "on",
                      "device heap", "host heap")
HEAP_STATES = ("device heap", "host heap")
#: what the heap states hold (the process after phases 1-5 holds ~4 GB of
#: the device beyond 6c's weights, ~2.8 GB more of the host and ~100,000
#: more objects the collector tracks): MB, and small dicts
HEAP_MB, HEAP_OBJECTS = 4096, 100_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, the published peak
LM_REL_F32 = 1e-4           # card vs CPU, f32 (6a, 6b)
LM_REL_DECODE_F32 = 1e-3    # decode vs the full forward, f32 (6b)
LM_REL_BF16 = 5e-2          # 6c: decode vs forward, bf16 vs f32 weights


def lm_prompt(cfg, seed: int, b: int, s: int):
    """(B, S) token ids, or (B, S, d) f32 embeddings for a stub frontend,
    from ``default_rng(seed)``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.takes_embeddings:
        return torch.tensor(rng.normal(size=(b, s, cfg.d_model)) * 0.3,
                            dtype=torch.float32)
    return torch.tensor(rng.integers(0, cfg.vocab, size=(b, s)))


def lm_rel(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


class GcClock:
    """The wall ms the garbage collector spends while the context is open,
    by generation, and its collections (through ``gc.callbacks``)."""

    def __enter__(self):
        self.ms, self.n, self._t0 = [0.0, 0.0, 0.0], [0, 0, 0], None
        gc.callbacks.append(self._tick)
        return self

    def _tick(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.ms[g] += (time.perf_counter() - self._t0) * 1e3
            self.n[g] += 1
            self._t0 = None

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._tick)


def lm_decode(params, cfg, prompt, n_new: int, device, *, cache_dtype,
              feed=None, timed: bool = False, clock: GcClock | None = None
              ) -> dict:
    """``prefill`` and ``n_new`` ``serve_step`` calls: the greedy chain
    (each step's argmax fed to the next, as ``greedy_generate``), or the
    tokens / embeddings of ``feed`` (B, n_new[, d]).  Returns the prefill
    logits, the steps' logits (B, n_new, vocab), the fed inputs, and with
    ``timed`` the prefill's and each step's wall ms (device-synchronised);
    with an open ``clock``, the collector's ms inside the steps and the CPU
    ms the steps took on this thread and in the whole process.
    """
    import torch

    from repro_torch.serve.step import prefill, serve_step

    def sync():
        if timed:
            torch.cuda.synchronize(device)
    s = prompt.shape[1]
    sync()
    t0 = time.perf_counter()
    cache, logits = prefill(params, cfg, prompt, max_len=s + n_new,
                            cache_dtype=cache_dtype, device=device)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None] if feed is None \
        else None
    steps, fed, step_ms = [], [], []
    gc_before = sum(clock.ms) if clock else 0.0
    thread_cpu = process_cpu = 0.0
    for j in range(n_new):
        if feed is not None:
            tok = feed[:, j:j + 1].to(device)
        c0, p0 = time.thread_time(), time.process_time()
        t0 = time.perf_counter()
        lg, cache = serve_step(params, cache, tok, s + j, cfg=cfg,
                               device=device)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        thread_cpu += time.thread_time() - c0
        process_cpu += time.process_time() - p0
        steps.append(lg)
        fed.append(tok)
        if feed is None:
            tok = torch.argmax(lg, dim=-1)[:, None]
    return dict(logits=logits, steps=torch.stack(steps, 1),
                fed=torch.cat(fed, 1), prefill_ms=prefill_ms,
                step_ms=step_ms,
                step_gc_ms=sum(clock.ms) - gc_before if clock else None,
                thread_cpu_ms=thread_cpu * 1e3, process_cpu_ms=process_cpu * 1e3)


def host_probe(device) -> dict:
    """The host's cost of fixed work, in us an item: a pure-Python loop
    (``python``), an in-place add on a 4-element tensor on ``device``
    (``op``: dispatch and launch) and an allocation of 4,096 floats there
    (``alloc``: dispatch and the caching allocator), each timed over 2,000
    items and synchronised once at its end."""
    import torch
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    py_us = (time.perf_counter() - t0) / 200_000 * 1e6
    x = torch.zeros(4, device=dev)
    times = []
    for make in (lambda: x.add_(1.0),
                 lambda: torch.empty(4096, device=dev)):
        sync()
        t0 = time.perf_counter()
        for _ in range(2000):
            make()
        sync()
        times.append((time.perf_counter() - t0) / 2000 * 1e6)
    return dict(python=py_us, op=times[0], alloc=times[1])


def profiler_session(device) -> None:
    """One ``torch.profiler`` session (host and, on the card, device
    activity) around a ``host_probe``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        host_probe(device)


def hold_heap(state: str, device, scale: float) -> list:
    """Memory for a heap state, ``scale`` x ``HEAP_MB`` MB in 1 MB pieces:
    "device heap" tensors on ``device``; "host heap" written numpy arrays
    with ``HEAP_OBJECTS`` x ``scale`` small dicts made among them."""
    import numpy as np
    import torch
    n = max(1, int(HEAP_MB * scale))
    if state == "device heap":
        return [torch.ones(262_144, device=device) for _ in range(n)]
    per = max(1, int(HEAP_OBJECTS * scale) // n)
    held = []
    for i in range(n):
        held.append(np.ones(131_072))
        held.extend({"i": i, "j": j} for j in range(per))
    return held


def lm_gc_turns(params, cfg, prompt, n_new: int, device,
                states=GC_STATES, heap_scale: float = 1.0) -> dict:
    """The greedy chain of ``lm_decode`` timed in each of ``states`` in
    turns, each after a ``host_probe``: the collector as the process has
    it ("on"), with every object alive before the chain left out of its
    scans ("frozen", ``gc.freeze``), disabled ("off"), on after glibc's
    ``malloc_trim(0)`` gave the heap's free pages back ("trimmed"), on
    after a ``profiler_session`` ("profiled"), and on while ``hold_heap``
    memory is held (the heap states, kept until the last turn).
    Returns the process's state
    (objects the collector tracks, dispatch and function modes, the
    profiler, threads, resident memory) and, per turn, the probe, the
    steps' median, min and max ms, their summed wall ms and CPU ms (this
    thread, the process), the collector's ms inside the steps and its
    collections by generation over the chain."""
    import torch
    timed = torch.device(device).type == "cuda"
    gc.collect()
    out = dict(objects=len(gc.get_objects()),
               dispatch_modes=torch._C._len_torch_dispatch_stack(),
               function_modes=torch._C._len_torch_function_stack(),
               profiler=bool(torch.autograd.profiler._is_profiler_enabled),
               threads=threading.active_count(),
               os_threads=len(os.listdir("/proc/self/task")),
               load=os.getloadavg()[0], cpus=len(os.sched_getaffinity(0)),
               rss_gb=resident_gb(),
               turns=[])
    held = []
    for state in states:
        gc.collect()
        if state in HEAP_STATES:
            held.append(hold_heap(state, device, heap_scale))
        elif state == "trimmed":
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        elif state == "profiled":
            profiler_session(device)
        probe = host_probe(device)
        if state == "frozen":
            gc.freeze()
        elif state == "off":
            gc.disable()
        try:
            with GcClock() as clock:
                run = lm_decode(params, cfg, prompt, n_new, device,
                                cache_dtype=torch.bfloat16, timed=timed,
                                clock=clock)
        finally:
            gc.enable()
            gc.unfreeze()
        ms = sorted(run["step_ms"])
        out["turns"].append(dict(
            state=state, probe=probe, median_ms=ms[len(ms) // 2],
            min_ms=ms[0], max_ms=ms[-1], wall_ms=sum(ms),
            thread_cpu_ms=run["thread_cpu_ms"],
            process_cpu_ms=run["process_cpu_ms"],
            step_gc_ms=run["step_gc_ms"], gc_ms=clock.ms,
            collections=clock.n, rss_gb=resident_gb()))
    return out


def resident_gb() -> float:
    """This process's resident host memory (``VmRSS``), GB."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("VmRSS:"))
    return kb * 1024 / 1e9


def lm_alone(device: str, full: bool) -> dict:
    """6c's model, prompt and warm-up in a process that holds nothing else,
    then ``lm_gc_turns`` over ``NEW_PROCESS_STATES``; run by
    ``lm_fresh_process``."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params
    arch, b, s, n_new = LM_QWEN
    cfg = get_config(arch) if full else get_smoke_config(arch)
    if not full:
        s, n_new = 40, 8
    dev = torch.device(device)
    params = init_params(cfg, seed=0, device=dev)
    prompt = lm_prompt(cfg, 3, b, s).to(dev)
    lm_decode(params, cfg, prompt, 2, dev, cache_dtype=torch.bfloat16,
              timed=dev.type == "cuda")                        # warm-up
    return lm_gc_turns(params, cfg, prompt, n_new, dev,
                       states=NEW_PROCESS_STATES,
                       heap_scale=1.0 if full else 0.01)


def lm_fresh_process(device: str, full: bool) -> dict:
    """``lm_alone`` in a new Python process: the decode step as a process
    that only serves sees it."""
    code = ("import json, sys, chip_smoke; print(json.dumps(chip_smoke."
            "lm_alone(sys.argv[1], sys.argv[2] == 'full')))")
    out = subprocess.run([sys.executable, "-c", code, str(device),
                          "full" if full else "smoke"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"6c in a new process failed:\n{out.stdout}\n"
                             f"{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def log_gc_turns(where: str, got: dict) -> None:
    log(f"6c decode {where}: {got['objects']:,} objects tracked by the "
        f"collector, {got['dispatch_modes']} dispatch / "
        f"{got['function_modes']} function modes, profiler "
        f"{'on' if got['profiler'] else 'off'}, {got['threads']} Python / "
        f"{got['os_threads']} OS threads, {got['cpus']} CPUs, load "
        f"{got['load']:.2f}, resident {got['rss_gb']:.2f} GB")
    for t in got["turns"]:
        gen = ", ".join(f"{n} / {ms:.1f} ms" for n, ms in
                        zip(t["collections"], t["gc_ms"]))
        p = t["probe"]
        log(f"  probe: python {p['python'] * 1e3:.1f} ns an item, op "
            f"{p['op']:.2f} us, alloc {p['alloc']:.2f} us")
        log(f"  {t['state']:11s}: step median {t['median_ms']:.3f} ms "
            f"(min {t['min_ms']:.3f}, max {t['max_ms']:.3f}); steps "
            f"{t['wall_ms']:.1f} ms wall, CPU {t['thread_cpu_ms']:.1f} ms "
            f"this thread / {t['process_cpu_ms']:.1f} ms the process; "
            f"resident {t['rss_gb']:.2f} GB; "
            f"collector "
            f"{t['step_gc_ms']:.1f} ms inside the steps; collections / ms "
            f"by generation 0, 1, 2 over the chain: {gen}")


def lm_card_vs_cpu(cfg, b: int, s: int, n_new: int, device) -> dict:
    """One seeded model (drawn on the CPU) in f32 on the CPU and on
    ``device``: the CPU's greedy chain, the same inputs fed to the device;
    prefill and decode logits within ``LM_REL_F32``.  Returns both runs and
    the device's params."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import init_params
    params_cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    params = copy.deepcopy(params_cpu).to(device)
    prompt = lm_prompt(cfg, 1, b, s)
    feed = None
    if cfg.takes_embeddings:
        feed = lm_prompt(cfg, 2, b, n_new)
    cpu = lm_decode(params_cpu, cfg, prompt, n_new, "cpu",
                    cache_dtype=torch.float32, feed=feed)
    card = lm_decode(params, cfg, prompt, n_new, device,
                     cache_dtype=torch.float32,
                     feed=cpu["fed"] if feed is None else feed)
    rel_pre = lm_rel(card["logits"].cpu(), cpu["logits"])
    rel_dec = lm_rel(card["steps"].cpu(), cpu["steps"])
    agree = float(np.mean(
        (torch.argmax(card["steps"], -1).cpu()
         == torch.argmax(cpu["steps"], -1)).numpy()))
    if not (torch.isfinite(card["steps"]).all()
            and torch.isfinite(card["logits"]).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits on {device}")
    if rel_pre > LM_REL_F32 or rel_dec > LM_REL_F32:
        raise AssertionError(f"{cfg.name}: {device} vs CPU rel prefill "
                             f"{rel_pre:.2e}, decode {rel_dec:.2e} > "
                             f"{LM_REL_F32}")
    return dict(cpu=cpu, card=card, params=params, prompt=prompt,
                rel_prefill=rel_pre, rel_decode=rel_dec, agree=agree)


def lm_profile(label: str, fn, reps: int, device) -> None:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler)
    and the device's busy share of their wall time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    records = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            records += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    if not by_name:
        log(f"profile of {label}: no device activity recorded (busy share: "
            f"not measured); {wall_ms / reps:.2f} ms a call under the "
            "profiler")
        return
    busy = sum(by_name.values())
    log(f"profile of {label}: device {busy / reps:.3f} ms a call in "
        f"{records / reps:.0f} device records, wall {wall_ms / reps:.3f} ms "
        f"a call under the profiler ({100 * busy / wall_ms:.1f}% busy); "
        "device ms a call by kernel:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms / reps:9.4f}  {name[:90]}")
    classes: dict[str, float] = {}
    for name, ms in by_name.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) \
            + ms
    log("  by class, device ms a call: " + ", ".join(
        f"{c} {ms / reps:.1f}" for c, ms in
        sorted(classes.items(), key=lambda kv: -kv[1])))


def kernel_class(name: str) -> str:
    """A device kernel's class, from its name: f32 GEMMs on FFMA (TF32
    off), other (bf16) GEMMs, copies and casts, reductions, elementwise,
    indexing, other."""
    n = name.lower()
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "f32 GEMM" if any(t in n for t in ("ffma", "sgemm",
                                                  "f32f32")) else "GEMM"
    for cls, tags in (("copy/cast", ("copy", "memcpy", "memset")),
                      ("reduction", ("reduce", "softmax", "norm")),
                      ("indexing", ("index", "scatter", "gather")),
                      ("elementwise", ("elementwise",))):
        if any(t in n for t in tags):
            return cls
    return "other"


def lm_profiles(params, cfg, prompt, device, steps: int = 4) -> None:
    """6c under the profiler: one prefill, then ``steps`` greedy decode
    steps from its cache."""
    import torch

    from repro_torch.serve.step import prefill, serve_step
    s = prompt.shape[1]
    state = {}

    def run_prefill():
        state["cache"], logits = prefill(params, cfg, prompt,
                                         max_len=s + steps, device=device)
        state["tok"] = torch.argmax(logits[:, -1], dim=-1)[:, None]
        state["pos"] = s

    def step():
        lg, state["cache"] = serve_step(params, state["cache"], state["tok"],
                                        state["pos"], cfg=cfg, device=device)
        state["tok"] = torch.argmax(lg, dim=-1)[:, None]
        state["pos"] += 1
    lm_profile("one prefill", run_prefill, 1, device)
    lm_profile(f"{steps} decode steps", step, steps, device)


def lm_phase(device: str, full: bool) -> None:
    """Phase 6: LM serving (``repro_torch.serve.step`` over
    ``repro_torch.models``).  ``full=False`` (the CPU rehearsal) runs 6b
    and 6c at their smoke configs."""

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.models import forward, init_params
    from repro_torch.serve.step import greedy_generate, prefill
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("allow_tf32 is on: the f32 parity checks need "
                             "torch's default (off)")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reset_counts()

    # -- 6a: the ten smoke configs, card vs CPU, f32 -----------------------
    b, s, n_new = LM_SMOKE
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        got = lm_card_vs_cpu(cfg, b, s, n_new, dev)
        log(f"6a {arch:18s} ({cfg.name}): prefill rel {got['rel_prefill']:.2e}, "
            f"decode rel {got['rel_decode']:.2e} (teacher-forced, {n_new} "
            f"steps); greedy tokens agree {100 * got['agree']:.1f}%")
    log(f"6a: {time.perf_counter() - t0:.1f} s")

    # -- 6b: mamba2-130m at its full config, f32 --------------------------
    arch, b, s, n_new = LM_MAMBA
    cfg = get_config(arch) if full else get_smoke_config(arch)
    if not full:
        s = 45
    t0 = time.perf_counter()
    got = lm_card_vs_cpu(cfg, b, s, n_new, dev)
    seq = torch.cat([got["prompt"].to(dev), got["card"]["fed"]], 1)
    pos = torch.arange(s + n_new, device=dev)[None].expand(b, -1)
    with torch.no_grad():
        full_logits, _, _ = forward(got["params"], cfg, seq, pos,
                                    device=dev)
    rel_fwd = lm_rel(got["card"]["steps"], full_logits[:, s:])
    log(f"6b {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.param_count() / 1e6:.1f}M params) f32, batch {b}, prompt "
        f"{s}, {n_new} new: card vs CPU prefill rel "
        f"{got['rel_prefill']:.2e}, decode rel {got['rel_decode']:.2e}; "
        f"decode vs full forward rel {rel_fwd:.2e} (gate "
        f"{LM_REL_DECODE_F32}); greedy tokens agree "
        f"{100 * got['agree']:.1f}%; {time.perf_counter() - t0:.1f} s")
    if rel_fwd > LM_REL_DECODE_F32:
        raise AssertionError(f"6b: decode vs full forward rel {rel_fwd:.2e}")
    del got, full_logits, seq

    # -- 6c: qwen2.5-3b at its full config, bf16 --------------------------
    arch, b, s, n_new = LM_QWEN
    cfg = get_config(arch) if full else get_smoke_config(arch)
    if not full:
        s, n_new = 40, 8
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"6c: {n_params} parameters, config says "
                             f"{cfg.param_count()}")
    log(f"6c {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params:,} params, {weight_bytes / 1e9:.3f} GB "
        f"bf16, drawn on {dev} in {init_s:.2f} s")
    prompt = lm_prompt(cfg, 3, b, s).to(dev)
    lm_decode(params, cfg, prompt, 2, dev, cache_dtype=torch.bfloat16,
              timed=on_card)                                   # warm-up
    # greedy_generate's peak, and what the process held before it (the
    # weights and whatever earlier phases keep)
    held = None
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, n_new, max_len=s + n_new,
                          device=dev)
    out_host = out.cpu()                     # waits for the device
    greedy_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    run = lm_decode(params, cfg, prompt, n_new, dev,
                    cache_dtype=torch.bfloat16, timed=on_card)
    step_ms = sorted(run["step_ms"])
    med = step_ms[len(step_ms) // 2]
    # the highest percentile with 10 samples above it (n = n_new)
    hi = max(len(step_ms) - 11, 0)
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    chain = torch.argmax(run["steps"], -1).cpu()
    agree = float(np.mean((chain == out_host).numpy()))
    log(f"6c batch {b}, prompt {s}, {n_new} new, bf16 weights and cache: "
        f"prefill {run['prefill_ms']:.2f} ms; decode step median "
        f"{med:.3f} ms (p{100 * (hi + 1) // len(step_ms)} "
        f"{step_ms[hi]:.3f}, min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}, "
        f"n {len(step_ms)}); "
        f"decode {b * 1e3 / med:.1f} tok/s; greedy_generate "
        f"{greedy_s * 1e3:.1f} ms for {b * n_new} tokens = "
        f"{b * n_new / greedy_s:.1f} tok/s (prefill included); peak "
        f"memory " + (f"{peak / 1e9:.3f} GB, {(peak - held) / 1e9:.3f} GB "
                      f"above the {held / 1e9:.3f} GB held before it"
                      if on_card else "not measured (CPU)") +
        f"; byte floor {weight_bytes / 1e9:.3f} GB / "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {floor_ms:.3f} ms a step "
        f"({floor_ms / med * 100:.1f}% of it); greedy_generate's tokens "
        f"equal the timed chain's on {100 * agree:.1f}%")
    if on_card:
        lm_profiles(params, cfg, prompt, dev)
    log_gc_turns("after the phases before it",
                 lm_gc_turns(params, cfg, prompt, n_new, dev))

    # decode logits vs the full forward over prompt + fed tokens
    seq = torch.cat([prompt, run["fed"]], 1)
    pos = torch.arange(s + n_new, device=dev)[None].expand(b, -1)
    with torch.no_grad():
        full_logits, _, _ = forward(params, cfg, seq, pos, device=dev)
    rel_fwd = lm_rel(run["steps"], full_logits[:, s:])
    fin = bool(torch.isfinite(run["steps"]).all()
               and torch.isfinite(run["logits"]).all())
    del full_logits, seq
    # bf16 prefill vs the same weights upcast to f32 (f32 cache)
    logits_bf16 = run["logits"]
    del run
    gc.collect()
    params.float()
    _, logits_f32 = prefill(params, cfg, prompt, max_len=s + n_new,
                            cache_dtype=torch.float32, device=dev)
    rel_f32 = lm_rel(logits_bf16, logits_f32)
    log(f"6c gates: decode vs full forward rel {rel_fwd:.3e}, bf16 vs f32 "
        f"weights prefill rel {rel_f32:.3e} (max|logit| "
        f"{float(logits_f32.abs().max()):.3f}; gate {LM_REL_BF16}); "
        f"finite {fin}")
    if not fin or out_host.shape != (b, n_new) or rel_fwd > LM_REL_BF16 \
            or rel_f32 > LM_REL_BF16:
        raise AssertionError("6c failed its gates")
    del params, logits_f32, logits_bf16
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log_gc_turns("in a new process", lm_fresh_process(device, full))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"phase 6 launched the solver's kernels: "
                             f"{launched}")
    log("phase 6 launched none of the port's kernels (the LM stack reaches "
        "no pl.pallas_call site)")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: LM training
# ---------------------------------------------------------------------------

#: 7a: one attention layer of qwen2.5-3b's training shape (B, S, KV, G,
#: hd), two query chunks of 1,024 over one KV chunk of 2,048
FLASH_SHAPE = (4, 2048, 2, 8, 128)
FLASH_REL_F32 = 1e-4        # the Function's grads vs autograd, f32 (7a)
#: 7b: every smoke config, card against CPU (batch, sequence)
TRAIN_SMOKE = (2, 32)
TRAIN_REL_F32 = 1e-4        # 7b: per leaf, x max(1, max|grad|)
#: 7c: the twin of examples/train_lm.py (mamba2-130m full config, bf16,
#: lr 1e-3), 30 steps with checkpoints every 10, then a resume from 20
TRAIN_MAMBA = dict(steps=30, batch=4, seq=256, every=10, resume_at=20)
TRAIN_RESUME_REL = 1e-5     # 7c: resumed vs straight losses (rel)
#: 7d: qwen2.5-3b at its full width, bf16, batch x seq, steps
TRAIN_QWEN = ("qwen2.5-3b", 4, 2048, 6)
TRAIN_REL_BF16 = 5e-2       # 7d: step-0 loss, bf16 vs f32 weights (rel)
BF16_DENSE_FLOPS = 989e12   # H100 SXM, dense bf16, the published peak


def cuda_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def flash_bwd_check(device, full: bool) -> None:
    """7a: ``flash_core``'s dq / dk / dv (the Function) against autograd
    through the plain forward loop (``_flash_fwd_impl``), f32, at one
    qwen2.5-3b attention layer of the training shape; then the Function's
    forward and backward ms in f32 and bf16."""
    import numpy as np
    import torch

    from repro_torch.models import flash_vjp
    b, s, kv, g, hd = FLASH_SHAPE if full else (2, 64, 2, 2, 16)
    qc, kc = s // 2, s
    rng = np.random.default_rng(21)
    q, do = (torch.tensor(rng.normal(size=(b, s, kv, g, hd)),
                          dtype=torch.float32, device=device)
             for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(b, s, kv, hd)),
                         dtype=torch.float32, device=device)
            for _ in range(2))
    pos = torch.arange(s, device=device)

    def grads(fn, dt):
        qkv = [t.to(dt).requires_grad_() for t in (q, k, v)]
        out = fn(*qkv, pos, pos, None, qc, kc)
        if isinstance(out, tuple):
            out = out[0]
        return torch.autograd.grad(out, qkv, do.to(dt))
    got = grads(flash_vjp.flash_core, torch.float32)
    want = grads(flash_vjp._flash_fwd_impl, torch.float32)
    rels = [lm_rel(a, w) for a, w in zip(got, want)]
    del want
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        qkv = [t.to(dt).requires_grad_() for t in (q, k, v)]
        dod = do.to(dt)
        out = flash_vjp.flash_core(*qkv, pos, pos, None, qc, kc)
        times[dt] = (
            time_ms(lambda: flash_vjp.flash_core(*qkv, pos, pos, None, qc,
                                                 kc), 3, device),
            time_ms(lambda: torch.autograd.grad(out, qkv, dod,
                                                retain_graph=True), 3,
                    device))
        if dt == torch.bfloat16:
            g16 = torch.autograd.grad(out, qkv, dod)
            rel16 = [lm_rel(a, w) for a, w in zip(g16, got)]
    flops = 4 * b * kv * g * s * s * hd            # q k^T and p v, causal x2
    log(f"7a flash backward at B {b}, S {s}, KV {kv}, G {g}, hd {hd} "
        f"(query chunks {s // qc} x {qc}, KV chunk {kc}): the Function's "
        f"dq / dk / dv vs autograd through the plain forward, f32: rel "
        f"{rels[0]:.2e} / {rels[1]:.2e} / {rels[2]:.2e} (gate "
        f"{FLASH_REL_F32}); bf16 vs f32 rel {rel16[0]:.2e} / "
        f"{rel16[1]:.2e} / {rel16[2]:.2e}; forward / backward ms (mean "
        f"of 3, CUDA events): f32 {times[torch.float32][0]:.2f} / "
        f"{times[torch.float32][1]:.2f}, bf16 "
        f"{times[torch.bfloat16][0]:.2f} / {times[torch.bfloat16][1]:.2f} "
        f"(forward products {flops / 1e9:.1f} GFLOP, the full square)")
    if max(rels) > FLASH_REL_F32 or not all(
            torch.isfinite(t).all() for t in got + g16):
        raise AssertionError(f"7a: flash backward rel {rels}")


def smoke_batch(cfg, seed: int, b: int, s: int) -> dict:
    """A batch of the synthetic pipeline (embeddings for a stub
    frontend)."""
    from repro_torch.data.pipeline import (DataConfig, sample_batch,
                                           sample_embedding_batch)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed)
    if cfg.takes_embeddings:
        return sample_embedding_batch(dcfg, 0, cfg.d_model)
    return sample_batch(dcfg, 0)


def train_card_vs_cpu(cfg, device) -> tuple[float, float, float]:
    """7b: one seeded f32 model (drawn on the CPU) on the CPU and on the
    card: ``loss_fn``'s gradients leaf by leaf within ``TRAIN_REL_F32`` x
    max(1, max|grad|), then one ``train_step`` each, its loss and grad
    norm within ``TRAIN_REL_F32``.  Returns the worst leaf's error and the
    two metrics' relative errors."""
    import copy

    import torch

    from repro_torch.models import init_params
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    card = copy.deepcopy(cpu).to(device)
    bt = smoke_batch(cfg, 5, *TRAIN_SMOKE)
    grads = []
    for model in (cpu, card):
        dev = model.embed.device
        total, _ = tstep.loss_fn(
            model, cfg, torch.as_tensor(bt["inputs"], device=dev),
            torch.as_tensor(bt["labels"], device=dev).long())
        grads.append(tstep._grads(model, total))
    worst = 0.0
    for name, want in grads[0].items():
        got = grads[1][name].cpu()
        err = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        worst = max(worst, err)
        if not err <= TRAIN_REL_F32:
            raise AssertionError(f"7b {cfg.name}: grad {name} rel {err:.2e}")
    ocfg = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    metrics = []
    for model, dev in ((cpu, "cpu"), (card, device)):
        _, m = tstep.train_step(model, init_opt_state(model), bt, cfg=cfg,
                                opt_cfg=ocfg, device=dev)
        metrics.append({k: float(v) for k, v in m.items()})
    rel_loss, rel_gn = (abs(metrics[1][k] / metrics[0][k] - 1)
                        for k in ("loss", "grad_norm"))
    if rel_loss > TRAIN_REL_F32 or rel_gn > TRAIN_REL_F32:
        raise AssertionError(f"7b {cfg.name}: loss rel {rel_loss:.2e}, "
                             f"grad norm rel {rel_gn:.2e}")
    return worst, rel_loss, rel_gn


def timed_train_step(times: list):
    """``train_step`` with each call's device-synchronised wall ms appended
    to ``times`` (for ``launch.train``, whose loop calls it)."""
    from repro_torch.train.step import train_step

    def step(model, *args, device, **kw):
        cuda_sync(device)
        t0 = time.perf_counter()
        out = train_step(model, *args, device=device, **kw)
        cuda_sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return step


def train_twin(device, full: bool) -> None:
    """7c: the twin of examples/train_lm.py through ``launch.train.main``
    (mamba2-130m's full config in bf16, lr 1e-3), 30 steps, checkpoints
    every 10 in a temporary directory; then ``LATEST`` pointed back at the
    step-20 file and a fresh ``main`` with ``--resume`` and the same
    ``--steps`` runs steps 20-29.  Gates: the resumed losses equal the
    straight run's within ``TRAIN_RESUME_REL`` (bitwise is printed), and the
    last 5 losses' mean below the first 5's."""
    import tempfile

    import numpy as np

    from repro_torch.launch import train as launch_train
    c = TRAIN_MAMBA
    with tempfile.TemporaryDirectory() as ck:
        args = ["--arch", "mamba2-130m", "--steps", str(c["steps"]),
                "--batch", str(c["batch"]), "--seq", str(c["seq"]),
                "--lr", "1e-3", "--ckpt-dir", ck, "--ckpt-every",
                str(c["every"]), "--log-every", "10", "--device",
                str(device)]
        if not full:
            args[args.index("--batch") + 1] = "2"
            args[args.index("--seq") + 1] = "32"
            args.append("--smoke")
        times: list[float] = []
        real = launch_train.train_step
        launch_train.train_step = timed_train_step(times)
        try:
            t0 = time.perf_counter()
            straight = launch_train.main(args)
            straight_s = time.perf_counter() - t0
            files = sorted(f for f in os.listdir(ck) if f.endswith(".ckpt"))
            size = os.path.getsize(os.path.join(ck, files[-1]))
            with open(os.path.join(ck, "LATEST"), "w") as f:
                f.write(f"step_{c['resume_at']:08d}.ckpt")
            t0 = time.perf_counter()
            resumed = launch_train.main(args + ["--resume"])
            resumed_s = time.perf_counter() - t0
        finally:
            launch_train.train_step = real
    want = straight[c["resume_at"]:]
    bitwise = resumed == want
    rel = max(abs(a / b - 1) for a, b in zip(resumed, want)) \
        if len(resumed) == len(want) else float("inf")
    first, last = np.mean(straight[:5]), np.mean(straight[-5:])
    med = sorted(times[1:c["steps"]])[(c["steps"] - 1) // 2]
    tokens = int(args[args.index("--batch") + 1]) * \
        int(args[args.index("--seq") + 1])
    log(f"7c train_lm twin ({'full' if full else 'smoke'} mamba2-130m, "
        f"bf16, {args[args.index('--batch') + 1]} x "
        f"{args[args.index('--seq') + 1]}, lr 1e-3): {c['steps']} steps in "
        f"{straight_s:.1f} s ({len(files)} checkpoints of {size / 1e9:.3f} "
        f"GB: {files}); ms a step median {med:.1f} (steps 2-{c['steps']}; "
        f"min {min(times[1:c['steps']]):.1f}, max "
        f"{max(times[1:c['steps']]):.1f}), {tokens * 1e3 / med:.0f} "
        f"tokens/s; loss first 5 {first:.4f} -> last 5 {last:.4f}; resumed "
        f"from step {c['resume_at']} in {resumed_s:.1f} s: {len(resumed)} "
        f"steps, {'bitwise' if bitwise else 'not bitwise'} the straight "
        f"run (max rel {rel:.2e}, gate {TRAIN_RESUME_REL})")
    if len(resumed) != c["steps"] - c["resume_at"] or rel > TRAIN_RESUME_REL \
            or not last < first or not np.isfinite(straight).all():
        raise AssertionError(f"7c failed: straight {straight}, resumed "
                             f"{resumed}")


def train_qwen(device, full: bool) -> None:
    """7d: qwen2.5-3b at its full width (hf:Qwen/Qwen2.5-3B), seed-0 bf16
    weights drawn on the card, f32 AdamW state, batch 4 x 2,048 from the
    synthetic pipeline, remat on, 6 steps.  Gates: the step-0 loss in bf16
    against the same weights upcast to f32 (forward only) within
    ``TRAIN_REL_BF16``; finite losses; a finite grad norm above 0; the
    parameters moved."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, sample_batch
    from repro_torch.models import init_params
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    arch, b, s, n_steps = TRAIN_QWEN
    cfg = get_config(arch) if full else get_smoke_config(arch)
    if not full:
        b, s = 2, 64
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    model = init_params(cfg, 0, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0)

    def loss0(m):
        bt = sample_batch(dcfg, 0)
        with torch.no_grad():
            _, met = tstep.loss_fn(
                m, cfg, torch.as_tensor(bt["inputs"], device=dev),
                torch.as_tensor(bt["labels"], device=dev).long())
        return float(met["loss"])
    l16 = loss0(model)
    f32 = copy.deepcopy(model).float()
    l32 = loss0(f32)
    del f32
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rel0 = abs(l16 / l32 - 1)

    state = init_opt_state(model)
    ocfg = AdamWConfig(lr=3e-4, total_steps=n_steps, warmup_steps=1)
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if n in ("embed", "blocks.0.wq", "blocks.0.ln1.scale",
                      "lm_head")}
    held = None
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    losses, gnorms, times = [], [], []
    for i in range(n_steps):
        bt = sample_batch(dcfg, i)
        cuda_sync(dev)
        t0 = time.perf_counter()
        state, m = tstep.train_step(model, state, bt, cfg=cfg,
                                    opt_cfg=ocfg, device=dev)
        cuda_sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    moved = {n: not torch.equal(p, dict(model.named_parameters())[n])
             for n, p in watch.items()}
    med = sorted(times[1:])[len(times[1:]) // 2]
    tokens = b * s
    n_matmul = sum(p.numel() for n, p in model.named_parameters()
                   if n != "embed")
    tflop = 6 * n_matmul * tokens / 1e12
    log(f"7d {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}; bf16 weights, f32 AdamW state, remat on) batch {b} x "
        f"{s}: step-0 loss bf16 {l16:.5f} vs f32 weights {l32:.5f} (rel "
        f"{rel0:.2e}, gate {TRAIN_REL_BF16}); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.3f}' for x in gnorms)}; ms a step "
        f"{', '.join(f'{x:.1f}' for x in times)}: median of steps 2-"
        f"{n_steps} {med:.1f} ms, {tokens * 1e3 / med:.0f} tokens/s; "
        f"{tflop:.2f} model TFLOP a step (6 x {n_matmul:,} matmul params x "
        f"{tokens} tokens) = {tflop * 1e15 / med / 1e12:.1f} TFLOP/s, "
        f"{100 * tflop * 1e15 / med / BF16_DENSE_FLOPS:.1f}% of "
        f"{BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s dense bf16 (H100 SXM); peak "
        "memory " + (f"{peak / 1e9:.3f} GB ({held / 1e9:.3f} GB held before "
                     "the first step)" if on_card else
                     "not measured (CPU)") +
        f"; parameters moved: {moved}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()
            and min(gnorms) > 0 and all(moved.values())
            and rel0 <= TRAIN_REL_BF16):
        raise AssertionError("7d failed its gates")
    if on_card:
        i = n_steps

        def one():
            tstep.train_step(model, state, sample_batch(dcfg, i), cfg=cfg,
                             opt_cfg=ocfg, device=dev)
        lm_profile("one qwen2.5-3b train step", one, 1, dev)
    del model, state, watch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def train_phase(device: str, full: bool) -> None:
    """Phase 7: LM training (``repro_torch.train`` over
    ``repro_torch.models``).  ``full=False`` (the CPU rehearsal) runs 7a at
    a small shape and 7c / 7d at their smoke configs."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    dev = torch.device(device)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("allow_tf32 is on: the f32 parity checks need "
                             "torch's default (off)")
    gc.collect()
    reset_counts()

    t0 = time.perf_counter()
    flash_bwd_check(dev, full)
    log(f"7a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        worst, rl, rg = train_card_vs_cpu(cfg, dev)
        log(f"7b {arch:18s}: grads worst leaf {worst:.2e} (x max(1, "
            f"max|grad|)), train_step loss rel {rl:.2e}, grad norm rel "
            f"{rg:.2e}")
    log(f"7b: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_twin(dev, full)
    log(f"7c: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_qwen(dev, full)
    log(f"7d: {time.perf_counter() - t0:.1f} s")
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"phase 7 launched the solver's kernels: "
                             f"{launched}")
    log("phase 7 launched none of the port's kernels (the training path "
        "reaches no pl.pallas_call site)")


# ---------------------------------------------------------------------------
# phase 8: the LM stack on a mesh
# ---------------------------------------------------------------------------

#: 8a: olmoe-1b-7b at its full config (arXiv:2409.02060), bf16, prefill of
#: batch x prompt tokens, sharded (the explicit-dispatch MoE) and not
MESH_PREFILL = ("olmoe-1b-7b", 4, 1536)
MESH_LOGIT_REL = 5e-2       # 8a: x max|logit|, bf16
#: 8b: olmoe-1b-7b at its full width, cut to 4 layers (memory), bf16
#: weights, f32 AdamW state, batch x seq, remat on
MESH_TRAIN = ("olmoe-1b-7b", 4, 4, 2048)
MESH_LOSS_REL, MESH_GRAD_REL = 1e-3, 5e-2   # 8b: loss rel; x max|g| a leaf
#: 8e: dry-run cells (arch, shape), each in a process of its own
MESH_DRYRUN = (("qwen2.5-3b", "train_4k"), ("olmoe-1b-7b", "train_4k"),
               ("qwen2.5-3b", "decode_32k"))


def shard_model(model, mesh):
    """``model``'s parameters as DTensors placed by ``params_shardings``."""
    from repro_torch import dist as D
    return D.distribute_params(model, D.params_shardings(model, mesh))


def shard_batch(mesh, t):
    """``t`` with its batch dim placed by ``batch_partition_spec``."""
    import torch

    from repro_torch import dist as D
    t = torch.as_tensor(t)
    return D.distribute(t, D.NamedSharding(
        mesh, D.batch_partition_spec(mesh, t.shape[0], t.ndim)))


def whole(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_prefill(mesh, device, full: bool) -> None:
    """8a: olmoe-1b-7b's prefill at its full config, unsharded and with the
    parameters and prompt placed on the mesh (``moe_apply_shardmap``
    engaged in every layer): logits within ``MESH_LOGIT_REL`` x max|logit|
    of each other; each prefill's ms."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dist import use_mesh
    from repro_torch.models import init_params, moe_shardmap
    from repro_torch.serve.step import prefill
    arch, b, s = MESH_PREFILL
    cfg = get_config(arch) if full else get_smoke_config(arch)
    if not full:
        b, s = 2, 40
    dtype = torch.bfloat16 if full else torch.float32
    model = init_params(cfg, 0, device=device, dtype=dtype)
    prompt = lm_prompt(cfg, 31, b, s).to(device)
    times, logits = [], []
    for sharded in (False, True):
        if sharded:
            shard_model(model, mesh)
        moe_shardmap.reset_engaged_count()
        for _ in range(2):                   # the second call is timed
            cuda_sync(device)
            t0 = time.perf_counter()
            if sharded:
                with use_mesh(mesh):
                    _, lg = prefill(model, cfg, shard_batch(mesh, prompt),
                                    max_len=s, device=device)
            else:
                _, lg = prefill(model, cfg, prompt, max_len=s,
                                device=device)
            cuda_sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        logits.append(whole(lg))
        engaged = moe_shardmap.engaged_count()
        if engaged != (2 * cfg.n_layers if sharded else 0):
            raise AssertionError(f"8a: the explicit-dispatch MoE engaged "
                                 f"{engaged} times (sharded={sharded})")
    rel = lm_rel(logits[1], logits[0])
    n = sum(p.numel() for p in model.parameters())
    log(f"8a {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.moe_top_k}, vocab {cfg.vocab}; "
        f"{n:,} parameters, {dtype}) prefill {b} x {s}: unsharded "
        f"{times[0]:.1f} ms, sharded on {tuple(mesh.mesh.shape)} "
        f"{times[1]:.1f} ms; logits rel {rel:.2e} (gate {MESH_LOGIT_REL} "
        f"x max|logit| = {float(logits[0].float().abs().max()):.3f}); "
        f"moe_apply_shardmap engaged {2 * cfg.n_layers} times in the two "
        "sharded calls")
    if not rel <= MESH_LOGIT_REL:
        raise AssertionError(f"8a: sharded prefill logits rel {rel:.3e}")
    del model, logits, lg
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _loss_grads(model, cfg, bt, mesh=None):
    """``loss_fn``'s loss and gradients (whole, by name) of ``model`` on
    batch ``bt``; on ``mesh`` the batch is placed and the call runs under
    ``use_mesh``."""
    import contextlib

    import torch

    from repro_torch.dist import use_mesh
    from repro_torch.train import step as tstep
    dev = model.embed.device
    inputs = torch.as_tensor(bt["inputs"], device=dev)
    labels = torch.as_tensor(bt["labels"], device=dev).long()
    if mesh is not None:
        inputs, labels = shard_batch(mesh, inputs), shard_batch(mesh, labels)
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        total, m = tstep.loss_fn(model, cfg, inputs, labels)
        grads = tstep._grads(model, total)
    return float(whole(m["loss"])), {n: whole(g) for n, g in grads.items()}


def _timed_step(model, cfg, bt, state, ocfg, device, mesh=None):
    """One ``train_step`` (under ``use_mesh`` with the batch placed on
    ``mesh``); returns (its metrics as floats, ms)."""
    import contextlib

    from repro_torch.dist import use_mesh
    from repro_torch.train import step as tstep
    if mesh is not None:
        bt = {k: shard_batch(mesh, v) for k, v in bt.items()}
    cuda_sync(device)
    t0 = time.perf_counter()
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        _, m = tstep.train_step(model, state, bt, cfg=cfg, opt_cfg=ocfg,
                                device=device)
    cuda_sync(device)
    return ({k: float(v) for k, v in m.items()},
            (time.perf_counter() - t0) * 1e3)


def mesh_train(mesh, device, full: bool) -> None:
    """8b: olmoe-1b-7b at its full width cut to 4 layers, bf16 weights,
    f32 AdamW state, remat: ``loss_fn`` and its gradients, then one
    ``train_step``, unsharded and then from the same seed-0 weights placed
    on the mesh.  Gates: loss rel ``MESH_LOSS_REL``, every gradient leaf
    within ``MESH_GRAD_REL`` x its max|g|, the explicit dispatch engaged;
    ms a step of both, peak memory."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, sample_batch
    from repro_torch.models import init_params, moe_shardmap
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    arch, layers, b, s = MESH_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers) if full \
        else get_smoke_config(arch)
    if not full:
        b, s = 2, 64
    dtype = torch.bfloat16 if full else torch.float32
    on_card = torch.device(device).type == "cuda"
    bt = sample_batch(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                                 seed=0), 0)
    ocfg = AdamWConfig(lr=3e-4, total_steps=10, warmup_steps=1)
    got = {}
    for sharded in (False, True):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        model = init_params(cfg, 0, device=device, dtype=dtype)
        on = mesh if sharded else None
        if sharded:
            shard_model(model, mesh)
        moe_shardmap.reset_engaged_count()
        loss, grads = _loss_grads(model, cfg, bt, on)
        engaged = moe_shardmap.engaged_count()
        if not sharded:
            grads = {n: g.cpu() for n, g in grads.items()}
        metrics, ms = _timed_step(model, cfg, bt, init_opt_state(model),
                                  ocfg, device, on)
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        got[sharded] = (loss, grads, metrics, ms, peak, engaged)
        del model
    n = sum(g.numel() for g in got[False][1].values())
    worst, worst_name = -1.0, None
    for name, want in got[False][1].items():
        g = got[True][1][name].cpu().float()
        err = float((g - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    rel_loss = abs(got[True][0] / got[False][0] - 1)
    fmt = (lambda p: f"{p / 1e9:.3f} GB" if p is not None else "n/a (CPU)")
    log(f"8b {cfg.name} cut to {cfg.n_layers} layers (d {cfg.d_model}, "
        f"{cfg.n_experts} experts; {n:,} parameters, {dtype} weights, f32 "
        f"AdamW state, remat) batch {b} x {s}: loss {got[False][0]:.5f} / "
        f"sharded {got[True][0]:.5f} (rel {rel_loss:.2e}, gate "
        f"{MESH_LOSS_REL}); worst gradient leaf {worst_name} {worst:.2e} "
        f"of its max|g| (gate {MESH_GRAD_REL}); train_step "
        f"{got[False][3]:.1f} ms / sharded {got[True][3]:.1f} ms (loss "
        f"{got[False][2]['loss']:.5f} / {got[True][2]['loss']:.5f}, grad "
        f"norm {got[False][2]['grad_norm']:.4f} / "
        f"{got[True][2]['grad_norm']:.4f}); peak memory {fmt(got[False][4])}"
        f" / {fmt(got[True][4])}; moe_apply_shardmap engaged "
        f"{got[True][5]} times in the sharded loss and gradient (forward "
        "and remat recompute), 0 unsharded")
    if not (rel_loss <= MESH_LOSS_REL and worst <= MESH_GRAD_REL
            and got[True][5] > 0 and got[False][5] == 0):
        raise AssertionError("8b failed its gates")
    del got
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def mesh_smoke(mesh, device) -> None:
    """8c: each smoke config (f32) on the card, ``loss_fn``'s gradients and
    one ``train_step`` unsharded and placed on the mesh: every leaf within
    ``TRAIN_REL_F32`` x max(1, max|g|), the loss and grad norm within rel
    ``TRAIN_REL_F32`` (phase 7b's gates)."""
    import copy

    import torch

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    ocfg = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
        bt = smoke_batch(cfg, 5, *TRAIN_SMOKE)
        res = []
        for sharded in (False, True):
            model = copy.deepcopy(cpu).to(device)
            on = mesh if sharded else None
            if sharded:
                shard_model(model, mesh)
            loss, grads = _loss_grads(model, cfg, bt, on)
            metrics, _ = _timed_step(model, cfg, bt, init_opt_state(model),
                                     ocfg, device, on)
            res.append((grads, metrics))
        worst = max(float((res[1][0][n] - g).abs().max())
                    / max(1.0, float(g.abs().max()))
                    for n, g in res[0][0].items())
        rl, rg = (abs(res[1][1][k] / res[0][1][k] - 1)
                  for k in ("loss", "grad_norm"))
        log(f"8c {arch:18s}: grads worst leaf {worst:.2e} (x max(1, "
            f"max|grad|)), train_step loss rel {rl:.2e}, grad norm rel "
            f"{rg:.2e}")
        if not (worst <= TRAIN_REL_F32 and rl <= TRAIN_REL_F32
                and rg <= TRAIN_REL_F32):
            raise AssertionError(f"8c {arch} failed its gates")


def mesh_reshard(device, dev_type: str) -> None:
    """8d: a smoke model's parameters and AdamW state placed on the (1, 1)
    ("data", "model") mesh, saved, and loaded onto a (1,) ("data",) mesh
    with that mesh's placements (``load_checkpoint(shardings=)``): every
    leaf bitwise the saved one."""
    import tempfile

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import dist as D
    from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import init_opt_state
    mesh2 = init_device_mesh(dev_type, (1, 1),
                             mesh_dim_names=("data", "model"))
    mesh1 = init_device_mesh(dev_type, (1,), mesh_dim_names=("data",))
    cfg = get_smoke_config("olmoe-1b-7b")
    model = shard_model(init_params(cfg, 0, device=device), mesh2)
    state = init_opt_state(model)
    for n in state.m:
        state.m[n].add_(0.5)
        state.v[n].add_(0.25)
    tree = (dict(model.named_parameters()), state)
    sh = D.params_shardings(model, mesh1)
    like = (dict(model.named_parameters()), state)
    shardings = (sh, type(state)(step=None, m=sh, v=sh))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        f = save_checkpoint(tmp, tree, step=7)
        t1 = time.perf_counter()
        (params, st), step = load_checkpoint(f, like, device=device,
                                             shardings=shardings)
        t2 = time.perf_counter()
    same = [n for n, p in params.items()
            if torch.equal(whole(p), whole(tree[0][n]))
            and p.device_mesh == mesh1 and torch.equal(whole(st.m[n]),
                                                      whole(state.m[n]))]
    log(f"8d reshard (1, 1) -> (1,): {len(params)} parameters and their "
        f"AdamW moments, step {step}; bitwise {len(same)} of "
        f"{len(params)}; save {t1 - t0:.2f} s, load {t2 - t1:.2f} s")
    if len(same) != len(params) or step != 7:
        raise AssertionError("8d: the resharded checkpoint differs")


def mesh_dryrun(full: bool) -> None:
    """8e: ``python -m repro_torch.launch.dryrun`` for ``MESH_DRYRUN``'s
    cells, each in a process of its own (a fake process group of 256
    ranks; host only), all started together: each cell's terms and
    seconds, and ``model_flops_per_device`` = ``cfg.model_flops`` /
    chips."""
    import tempfile

    from repro_torch.configs import SHAPES, get_config
    todo = MESH_DRYRUN if full else (("mamba2-130m", "decode_32k"),)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", tmp], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for arch, shape in todo]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for (arch, shape), p, out in zip(todo, procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"8e dry-run {arch} x {shape} exited "
                                     f"{p.returncode}:\n{out[-3000:]}")
            terms = json.load(open(f"{tmp}/{arch}__{shape}__single.json"))
            spec = SHAPES[shape]
            mf = get_config(arch).model_flops(
                spec.global_batch, spec.seq_len, decode=spec.kind == "decode")
            if spec.kind == "prefill":
                mf /= 3.0
            if terms["model_flops_per_device"] != mf / terms["chips"]:
                raise AssertionError(f"8e {arch} x {shape}: model FLOPs a "
                                     "device differ from cfg.model_flops")
            log(f"8e {arch} x {shape} on {terms['mesh_axes']}: "
                f"{terms['compile_seconds']:.1f} s of op recording; FLOPs "
                f"{terms['flops_per_device']:.4g}, bytes "
                f"{terms['bytes_per_device']:.4g}, collective wire bytes "
                f"{terms['collective_bytes_per_device']:.4g} a device "
                f"({terms['collective_counts']}); t_compute "
                f"{terms['t_compute_s']:.4g} s, t_memory "
                f"{terms['t_memory_s']:.4g} s, t_collective "
                f"{terms['t_collective_s']:.4g} s, dominant "
                f"{terms['dominant']}; model FLOPs a device "
                f"{terms['model_flops_per_device']:.4g} (= cfg.model_flops "
                f"/ {terms['chips']}), useful ratio "
                f"{terms['useful_flops_ratio']:.3f}, roofline fraction "
                f"{terms['roofline_fraction']:.4f}; arguments "
                f"{terms['argument_size_in_bytes'] / 1e9:.3f} GB a device")
        log(f"8e: {len(todo)} cells in {wall:.1f} s wall, in parallel")


def mesh_lm_phase(device: str, full: bool) -> None:
    """Phase 8: the LM stack on a (1, 1) ("data", "model") mesh over a
    one-rank process group (NCCL on the card, gloo on the CPU).
    ``full=False`` (the CPU rehearsal) runs 8a / 8b at smoke configs and
    8e on one decode cell."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(device)
    dev_type = dev.type
    gc.collect()
    reset_counts()
    if dev_type == "cuda":
        # the rank's card, selected before the mesh is made
        torch.cuda.set_device(torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_host_mesh(dev_type)
            log(f"process group {dist.get_backend()}, world size "
                f"{dist.get_world_size()}; mesh {mesh}")
            for name, fn in (("8a", lambda: mesh_prefill(mesh, dev, full)),
                             ("8b", lambda: mesh_train(mesh, dev, full)),
                             ("8c", lambda: mesh_smoke(mesh, dev)),
                             ("8d", lambda: mesh_reshard(dev, dev_type))):
                t0 = time.perf_counter()
                fn()
                log(f"{name}: {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    mesh_dryrun(full)
    log(f"8e: {time.perf_counter() - t0:.1f} s")
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"phase 8 launched the solver's kernels: "
                             f"{launched}")
    log("phase 8 launched none of the port's kernels (the LM stack on a "
        "mesh reaches no pl.pallas_call site)")


def kernel_row(name, launches, cuda_launches, err, ms, plain_ms, bnd, by,
               lib_ms) -> dict:
    """A row of the kernels line: ``launches`` are wrapper calls on the
    main path, ``cuda_launches`` the CUDA launches they issued."""
    return {"name": name, **KERNELS[name], "launches": launches,
            "cuda_launches": cuda_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


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
    from repro_torch.analysis.traffic import (bound, spmv_bytes,
                                              trisolve_bytes)
    from repro_torch.core import (PAPER_PROBLEMS, PAPER_SHIFTS, build_plan,
                                  paper_problem)
    from repro_torch.core.sell import permute_round_major
    from repro_torch.kernels import (_build, hbmc_trisolve,
                                     hbmc_trisolve_batched,
                                     hbmc_trisolve_batched_ref,
                                     hbmc_trisolve_fused,
                                     hbmc_trisolve_fused_batched,
                                     hbmc_trisolve_fused_batched_ref,
                                     hbmc_trisolve_fused_ref,
                                     hbmc_trisolve_ref, sell_spmv,
                                     sell_spmv_batched, sell_spmv_batched_ref,
                                     sell_spmv_ref)
    from repro_torch.kernels.sell_spmv import batched_launch
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
        kw = dict(plan_kw, shift=PAPER_SHIFTS.get(name, 0.0))
        plan = build_plan(a, **kw)
        check_kernels(plan, f"{name}/{scale}", seed=10 + i)
        check_batched_kernels(plan, f"{name}/{scale}", seed=40 + i)
        check_shard_steps(plan, f"{name}/{scale}", seed=80 + i)
        check_sweep_kernels(build_plan(a, layout="index", **kw),
                            f"{name}/{scale} index", seed=60 + i)
        if name == "thermal2":
            plan32 = build_plan(a, dtype=torch.float32, **plan_kw)
            check_kernels(plan32, f"{name}/{scale}", seed=20)
            check_batched_kernels(plan32, f"{name}/{scale}", seed=50)
            check_shard_steps(plan32, f"{name}/{scale}", seed=90)
            check_sweep_kernels(
                build_plan(a, dtype=torch.float32, layout="index",
                           **plan_kw), f"{name}/{scale} index", seed=70)
        del plan
    plan_main = build_plan(a_main, **plan_kw)
    check_kernels(plan_main, f"thermal2/n={a_main.shape[0]}", seed=30)
    check_batched_kernels(plan_main, f"thermal2/n={a_main.shape[0]}",
                          seed=31)
    check_shard_steps(plan_main, f"thermal2/n={a_main.shape[0]}", seed=37,
                      sizes=(None, BATCH))
    check_repeats(hbmc_trisolve_fused, plan_main._precond.tables, True, None,
                  35, f"B1 thermal2/n={a_main.shape[0]}")
    check_repeats(hbmc_trisolve_fused_batched, plan_main._precond.tables,
                  True, BATCH, 33,
                  f"B3 thermal2/n={a_main.shape[0]} B={BATCH}")
    del plan_main
    t0 = time.perf_counter()
    plan_idx = build_plan(a_main, layout="index", **plan_kw)
    idx_setup_s = time.perf_counter() - t0
    check_sweep_kernels(plan_idx, f"thermal2/n={a_main.shape[0]} index",
                        seed=32, sizes=(BATCH,))
    for sweep, tab in (("fwd", plan_idx._precond.kernel.fwd),
                       ("bwd", plan_idx._precond.kernel.bwd)):
        check_repeats(hbmc_trisolve, tab, False, None, 36,
                      f"B5 thermal2/n={a_main.shape[0]} {sweep}")
        check_repeats(hbmc_trisolve_batched, tab, False, BATCH, 34,
                      f"B6 thermal2/n={a_main.shape[0]} {sweep} B={BATCH}")

    # -- 3. main path ---------------------------------------------------------
    log("== 3. main path: build_plan + solve, thermal2 "
        f"n={a_main.shape[0]} nnz={a_main.nnz}")
    b = np.random.default_rng(7).normal(size=a_main.shape[0])
    reset_counts()
    t0 = time.perf_counter()
    plan = build_plan(a_main, **plan_kw)
    setup_s = time.perf_counter() - t0
    rep = plan.solve(b)
    counts = kernels.launch_counts()
    cuda_main = kernels.cuda_launch_counts()
    res = rep.result
    k, blocks = loop_blocks([res.iterations], "solve", on_card)
    true_relres = float(np.linalg.norm(b - a_main @ rep.x)
                        / np.linalg.norm(b))
    t = plan._precond.tables
    log(f"setup {setup_s:.3f} s ({plan.timings}); colors {plan.n_colors}, "
        f"S={t.n_steps}, tables {tuple(t.cols.shape)}, SELL "
        f"{tuple(plan._spmv_vals.shape)}")
    log(f"solve: status {res.status}, iterations {res.iterations}, relres "
        f"{res.relres:.3e}, true relres {true_relres:.3e}, "
        f"{rep.solve_seconds:.3f} s; launches {counts}; CUDA launches "
        f"{cuda_main}")
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
        want.update(hbmc_trisolve_fused=1 + k * blocks,
                    sell_spmv=k * blocks)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    want_cuda = cuda_launches_want(
        on_card, hbmc_trisolve_fused=t.segments.size * (1 + k * blocks),
        sell_spmv=k * blocks)
    if cuda_main != want_cuda:
        raise AssertionError(f"CUDA launches {cuda_main}, expected "
                             f"{want_cuda}")
    graph_cache_phase(plan, a_main, b, rep, plan_kw, on_card)
    segment_phase(plan, plan_idx, grid)
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
    rep_b, b8, counts_b, cuda_b = solve_batched_phase(plan, a_main,
                                                      on_card)

    # -- 3c. serving ----------------------------------------------------------
    log(f"== 3c. serving: SolverService(slab_width={BATCH}, "
        f"quantum={SERVE_QUANTUM}), {SERVE_REQUESTS} requests, same matrix")
    serve_s, serve_n, _ = serve_phase(a_main, plan_kw, on_card)

    # -- 3d. index layout -----------------------------------------------------
    kp = plan_idx._precond.kernel
    log(f"== 3d. index layout: build_plan(layout='index') + solve and "
        f"solve_batched B={BATCH}, same matrix; plan setup "
        f"{idx_setup_s:.3f} s, sweep tables fwd {tuple(kp.fwd.cols.shape)}, "
        f"bwd {tuple(kp.bwd.cols.shape)}")
    counts_idx, counts_idx_b, cuda_idx, cuda_idx_b = index_phase(
        plan_idx, a_main, plan, plan_kw, b, b8, iterations, on_card)

    # -- 3e. smoother ---------------------------------------------------------
    log(f"== 3e. smoother: GS and SOR(1.5), {SMOOTHER_SWEEPS} sweeps each on "
        f"the index plan's HBMC-ordered system")
    smooth_ms = smoother_phase(plan_idx, b, device)

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

    err_tri = max_abs(hbmc_trisolve_fused(t.cols, t.vals, t.dinv, q,
                                          segments=t.segments),
                      hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q))
    y_k = sell_spmv(sv, sc, x)
    err_spmv = max_abs(y_k, sell_spmv_ref(sv, sc, x))
    err_tri_b = max_abs(
        hbmc_trisolve_fused_batched(t.cols, t.vals, t.dinv, qb,
                                    segments=t.segments),
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
    log("B1 in turns (ms per apply):")
    tri_ms = single_rhs_turns(hbmc_trisolve_fused, hbmc_trisolve_fused_batched,
                              t, q, reps, dev, "B1")["B"]
    tri_launches = cuda_launches_per_call(lambda: hbmc_trisolve_fused(
        t.cols, t.vals, t.dinv, q, segments=t.segments))
    tri_plain_ms = time_ms(
        lambda: hbmc_trisolve_fused_ref(t.cols, t.vals, t.dinv, q),
        max(reps // 5, 1), dev)
    spmv_ms = time_ms(lambda: sell_spmv(sv, sc, x), 4 * reps, dev)
    spmv_plain_ms = time_ms(lambda: sell_spmv_ref(sv, sc, x), reps, dev)
    spmv_lib_ms = time_ms(lambda: torch.mv(a_lib, x), 4 * reps, dev)
    # what the wrappers' bookkeeping (kernels/_trace.py: the depth mark and
    # the operand bytes) costs a host-issued call: B2 through its wrapper
    # and through the undecorated body, in turns A B B A
    bare = sell_spmv.__wrapped__
    b2_turns = [time_ms(lambda f=f: f(sv, sc, x), 4 * reps, dev)
                for f in (sell_spmv, bare, bare, sell_spmv)]
    log("B2 host-issued, wrapper / undecorated body / undecorated body / "
        "wrapper: " + " / ".join(f"{v:.4f}" for v in b2_turns) + " ms")
    solve_reps = 5 if on_card else 1
    iter_ms = loop_ms(plan.solve, b, solve_reps)

    def b3(segs):
        return lambda: hbmc_trisolve_fused_batched(
            t.cols, t.vals, t.dinv, qb, segments=segs)

    # in turns: the tables' segments, then one launch per step
    b3_cuts = (t.segments, np.arange(2 * t.n_steps))
    tri_b_turns = [time_ms(b3(b3_cuts[i % 2]), reps, dev) for i in range(4)]
    tri_b_ms = (tri_b_turns[0] + tri_b_turns[2]) / 2
    tri_b_launches = [cuda_launches_per_call(b3(c)) for c in b3_cuts]
    tri_b_plain_ms = time_ms(
        lambda: hbmc_trisolve_fused_batched_ref(t.cols, t.vals, t.dinv, qb),
        max(reps // 5, 1), dev)
    spmv_b_ms = time_ms(lambda: sell_spmv_batched(sv, sc, xb), 4 * reps, dev)
    spmv_b_plain_ms = time_ms(lambda: sell_spmv_batched_ref(sv, sc, xb),
                              reps, dev)
    spmv_b_lib_ms = time_ms(lambda: torch.sparse.mm(a_lib, xb), 4 * reps,
                            dev)
    # B4 on local cols: each row's K entries point at the row itself, so
    # vals, cols and y move the real call's bytes and x is read once, in
    # order; and a device copy that moves the bound's bytes
    ns, nk, nw = sc.shape
    sc_local = (torch.arange(ns * nw, dtype=torch.int32, device=dev)
                .reshape(ns, 1, nw).expand(ns, nk, nw).contiguous())
    spmv_b_local_ms = time_ms(lambda: sell_spmv_batched(sv, sc_local, xb),
                              4 * reps, dev)
    # the scalar variant at the same shapes: x one element into its storage
    xb_buf = torch.empty(xb.numel() + 1, dtype=xb.dtype, device=dev)
    xb_off = xb_buf[1:].view(xb.shape)
    xb_off.copy_(xb)
    if not torch.equal(sell_spmv_batched(sv, sc, xb_off), y_kb):
        raise AssertionError("B4's scalar variant is not bitwise its vector "
                             "variant at the 1M shapes")
    spmv_b_scalar_ms = time_ms(lambda: sell_spmv_batched(sv, sc, xb_off),
                               4 * reps, dev)
    copy_src = torch.empty(spmv_bytes(sv, sc, xb) // 2, dtype=torch.uint8,
                           device=dev)
    copy_dst = torch.empty_like(copy_src)
    copy_ms = time_ms(lambda: copy_dst.copy_(copy_src), 4 * reps, dev)
    del sc_local, copy_src, copy_dst, xb_buf, xb_off
    iter_b_ms = loop_ms(plan.solve_batched, b8, solve_reps)
    # the single-RHS loop once more, after the batched work, as a check on
    # how much the host loop's time depends on what ran before it
    iter_late_ms = loop_ms(plan.solve, b, solve_reps)

    def tri_bound(tab, qq):
        """Bytes of ``trisolve_bytes``; per lane and column 2K operations
        for the sum and 2 for the subtract and scale."""
        return bound(trisolve_bytes(tab, qq),
                     (2 * tab.vals.numel() + 2 * tab.dinv.numel())
                     * (qq.numel() // tab.dinv.numel()), plan.dtype)

    def spmv_bound(xx):
        return bound(spmv_bytes(sv, sc, xx),
                     2 * sv.numel() * (xx.numel() // xx.shape[0]),
                     plan.dtype)

    tri_bnd, tri_by = tri_bound(t, q)
    spmv_bnd, spmv_by = spmv_bound(x)
    tri_b_bnd, tri_b_by = tri_bound(t, qb)
    spmv_b_bnd, spmv_b_by = spmv_bound(xb)
    log(f"trisolve apply: kernel {tri_ms:.4f}  plain {tri_plain_ms:.4f}  "
        f"bound {tri_bnd:.4f} ({tri_by}, "
        f"{trisolve_bytes(t, q) / 1e6:.1f} MB; {tri_launches} CUDA launches "
        f"per call)")
    log(f"SELL SpMV:      kernel {spmv_ms:.4f}  plain {spmv_plain_ms:.4f}  "
        f"bound {spmv_bnd:.4f} ({spmv_by}, "
        f"{spmv_bytes(sv, sc, x) / 1e6:.1f} MB)  torch.mv CSR "
        f"{spmv_lib_ms:.4f}")
    log(f"PCG iteration:  {spread(iter_ms)} ms; host setup "
        f"{setup_s * 1e3:.1f} ms")
    log(f"batched trisolve apply B3, B={BATCH}: kernel {tri_b_ms:.4f}  "
        f"plain {tri_b_plain_ms:.4f}  bound {tri_b_bnd:.4f} ({tri_b_by}, "
        f"{trisolve_bytes(t, qb) / 1e6:.1f} MB; {tri_b_launches[0]} CUDA "
        f"launches per call)")
    log(f"  B3 in turns, segments / per step ({tri_b_launches[1]} launches)"
        f": {' / '.join(f'{ms:.4f}' for ms in tri_b_turns)}; segments take "
        f"{2 * tri_b_ms / (tri_b_turns[1] + tri_b_turns[3]):.3f} of the "
        f"per-step time")
    log(f"batched SELL SpMV, B={BATCH}: kernel {spmv_b_ms:.4f}  plain "
        f"{spmv_b_plain_ms:.4f}  bound {spmv_b_bnd:.4f} ({spmv_b_by}, "
        f"{spmv_bytes(sv, sc, xb) / 1e6:.1f} MB)  torch.sparse.mm CSR "
        f"{spmv_b_lib_ms:.4f}")
    b4 = batched_launch(*sv.shape, BATCH, sv.dtype, xb.data_ptr() % 16)
    b4_regs = (_build.load_library().lib.sell_spmv_batched_registers(
        sv.element_size(), b4.cols_per_thread, b4.k_unrolled) if on_card
        else "not measured")
    log(f"  B4 variant: {'vector' if b4.vector else 'scalar'}, "
        f"{b4.cols_per_thread} columns a thread, K "
        f"{b4.k_unrolled or 'in chunks of 8'} unrolled, {b4.blocks} blocks "
        f"x {b4.threads} threads (the rows' two halves side by side), "
        f"registers a thread: {b4_regs}; bound {spmv_b_bnd:.4f}; scalar "
        f"variant (x one element off 16 bytes) {spmv_b_scalar_ms:.4f}")
    copy_mb = spmv_bytes(sv, sc, xb) // 2 * 2 / 1e6
    log(f"  B4 on local cols (x read once, in order): {spmv_b_local_ms:.4f}"
        f"; real / local {spmv_b_ms / spmv_b_local_ms:.3f}; device copy "
        f"moving {copy_mb:.1f} MB: {copy_ms:.4f} ms "
        f"({copy_mb / 1e3 / copy_ms:.3f} TB/s)")
    iter_b_med = iter_b_ms[len(iter_b_ms) // 2]
    log(f"batched PCG iteration, B={BATCH}: {spread(iter_b_ms)} ms, "
        f"{iter_b_med / BATCH:.4f} ms per column at the median")
    log(f"PCG iteration again, after the batched timings: "
        f"{spread(iter_late_ms)} ms")
    log(f"service: {serve_n} requests in {serve_s:.3f} s wall, "
        f"{serve_n / serve_s:.2f} solves/s (plan build included)")

    # the index layout: one sweep (forward tables), B5 and B6 at B = 8
    tf = plan_idx._precond.kernel.fwd
    qs = torch.tensor(rng.normal(size=tuple(tf.dinv.shape)), device=dev)
    qsb = torch.tensor(rng.normal(size=tuple(tf.dinv.shape) + (BATCH,)),
                       device=dev)
    y_sw = hbmc_trisolve(tf.cols, tf.vals, tf.dinv, qs, segments=tf.segments)
    y_sw_b = hbmc_trisolve_batched(tf.cols, tf.vals, tf.dinv, qsb,
                                   segments=tf.segments)
    err_sw = max_abs(y_sw, hbmc_trisolve_ref(tf.cols, tf.vals, tf.dinv, qs))
    err_sw_b = max_abs(y_sw_b, hbmc_trisolve_batched_ref(tf.cols, tf.vals,
                                                         tf.dinv, qsb))
    log("B5 in turns (ms per sweep, forward table):")
    sw_ms = single_rhs_turns(hbmc_trisolve, hbmc_trisolve_batched, tf, qs,
                             reps, dev, "B5")["B"]
    sw_launches = cuda_launches_per_call(lambda: hbmc_trisolve(
        tf.cols, tf.vals, tf.dinv, qs, segments=tf.segments))
    sw_plain_ms = time_ms(
        lambda: hbmc_trisolve_ref(tf.cols, tf.vals, tf.dinv, qs),
        max(reps // 5, 1), dev)

    def b6(segs):
        return lambda: hbmc_trisolve_batched(
            tf.cols, tf.vals, tf.dinv, qsb, segments=segs)

    b6_cuts = (tf.segments, np.arange(tf.cols.shape[0]))
    sw_b_turns = [time_ms(b6(b6_cuts[i % 2]), reps, dev) for i in range(4)]
    sw_b_ms = (sw_b_turns[0] + sw_b_turns[2]) / 2
    sw_b_launches = [cuda_launches_per_call(b6(c)) for c in b6_cuts]
    sw_b_plain_ms = time_ms(
        lambda: hbmc_trisolve_batched_ref(tf.cols, tf.vals, tf.dinv, qsb),
        max(reps // 5, 1), dev)
    sw_lib_ms, sw_b_lib_ms = library_sweep_ms(tf, qs, qsb, y_sw, y_sw_b,
                                              reps, dev)
    # the library's apply (B1 / B3's yardstick): SpSV on L, then on L^T
    # (SpSM at B = 8) -- the index plan's two sweeps of the same factor
    tb = plan_idx._precond.kernel.bwd
    bw_lib_ms, bw_b_lib_ms = library_sweep_ms(
        tb, qs, qsb, hbmc_trisolve(tb.cols, tb.vals, tb.dinv, qs,
                                   segments=tb.segments),
        hbmc_trisolve_batched(tb.cols, tb.vals, tb.dinv, qsb,
                              segments=tb.segments), reps, dev)
    apply_lib_ms = (None if None in (sw_lib_ms, bw_lib_ms)
                    else sw_lib_ms + bw_lib_ms)
    apply_b_lib_ms = (None if None in (sw_b_lib_ms, bw_b_lib_ms)
                      else sw_b_lib_ms + bw_b_lib_ms)
    sw_bnd, sw_by = tri_bound(tf, qs)
    sw_b_bnd, sw_b_by = tri_bound(tf, qsb)
    # one HBMC -> round-major permutation of an (n, 8) block: the port's
    # scatter, and the reference's row gather qp[rows] for comparison
    n_idx = plan_idx.n_padded
    q_hbmc = torch.tensor(rng.normal(size=(n_idx, BATCH)), device=dev)
    qp = torch.cat([q_hbmc, q_hbmc.new_zeros((1, BATCH))])
    rows_ref = torch.clamp(tf.rows, max=n_idx)
    perm_ms = time_ms(lambda: tf.to_round_major(q_hbmc), reps, dev)
    perm_gather_ms = time_ms(lambda: qp[rows_ref], reps, dev)
    iter_idx_ms = loop_ms(plan_idx.solve, b, solve_reps)
    iter_idx_b_ms = loop_ms(plan_idx.solve_batched, b8, solve_reps)
    iter_rm_ms = loop_ms(plan.solve, b, solve_reps)
    iter_rm_b_ms = loop_ms(plan.solve_batched, b8, solve_reps)
    sw_lanes = tf.dinv.shape
    log(f"index sweep (B5, one of two per apply): kernel {sw_ms:.4f}  "
        f"plain {sw_plain_ms:.4f}  bound {sw_bnd:.4f} ({sw_by}, "
        f"{trisolve_bytes(tf, qs) / 1e6:.1f} MB; {sw_launches} CUDA "
        f"launches per call)  "
        f"library {fmt_ms(sw_lib_ms)}")
    log(f"library apply (SpSV on L then on L^T, the index plan's two "
        f"sweeps; B1's yardstick): {fmt_ms(sw_lib_ms)} + {fmt_ms(bw_lib_ms)}"
        f" = {fmt_ms(apply_lib_ms)} ms; at B={BATCH} (SpSM, B3's): "
        f"{fmt_ms(sw_b_lib_ms)} + {fmt_ms(bw_b_lib_ms)} = "
        f"{fmt_ms(apply_b_lib_ms)} ms")
    log(f"index sweep B6, B={BATCH}: kernel {sw_b_ms:.4f}  plain "
        f"{sw_b_plain_ms:.4f}  bound {sw_b_bnd:.4f} ({sw_b_by}, "
        f"{trisolve_bytes(tf, qsb) / 1e6:.1f} MB; {sw_b_launches[0]} CUDA "
        f"launches per call)  library {fmt_ms(sw_b_lib_ms)}")
    log(f"  B6 in turns, segments / per step ({sw_b_launches[1]} launches)"
        f": {' / '.join(f'{ms:.4f}' for ms in sw_b_turns)}; segments take "
        f"{2 * sw_b_ms / (sw_b_turns[1] + sw_b_turns[3]):.3f} of the "
        f"per-step time")
    log(f"index PCG iteration: {spread(iter_idx_ms)} ms; round-major in "
        f"turn: {spread(iter_rm_ms)} ms")
    med_idx_b = iter_idx_b_ms[len(iter_idx_b_ms) // 2]
    med_rm_b = iter_rm_b_ms[len(iter_rm_b_ms) // 2]
    log(f"index batched PCG iteration, B={BATCH}: {spread(iter_idx_b_ms)} "
        f"ms, {med_idx_b / BATCH:.4f} ms per column; round-major in turn: "
        f"{spread(iter_rm_b_ms)} ms, {med_rm_b / BATCH:.4f} per column")
    log(f"index permutation of an (n, {BATCH}) block, HBMC -> round-major: "
        f"scatter (the port) {perm_ms:.4f} ms, row gather qp[rows] (the "
        f"reference's form) {perm_gather_ms:.4f} ms; 4 per apply")
    log(f"GS sweep on the main HBMC system (PyTorch ops, "
        f"{sw_lanes[0]} rounds): {smooth_ms:.4f} ms")
    log("PCG loops, replayed graphs against eager blocks, in turns:")
    graph_turns(plan, plan_idx, b, b8, 3 if on_card else 1)
    profile_solve(plan, b, b8)
    profile_solve(plan_idx, b, b8, tag="index ")

    # CUDA launches: B1, B2 from the main solve, B3, B4 from the batched
    # solve, B5 from the index solve and B6 from the index batched solve
    rows = [
        kernel_row("hbmc_trisolve_fused", counts["hbmc_trisolve_fused"],
                   cuda_main["hbmc_trisolve_fused"], err_tri, tri_ms,
                   tri_plain_ms, tri_bnd, tri_by, apply_lib_ms),
        kernel_row("sell_spmv", counts["sell_spmv"], cuda_main["sell_spmv"],
                   err_spmv, spmv_ms, spmv_plain_ms, spmv_bnd, spmv_by,
                   spmv_lib_ms),
        kernel_row("hbmc_trisolve_fused_batched",
                   counts_b["hbmc_trisolve_fused_batched"],
                   cuda_b["hbmc_trisolve_fused_batched"], err_tri_b,
                   tri_b_ms, tri_b_plain_ms, tri_b_bnd, tri_b_by,
                   apply_b_lib_ms),
        kernel_row("sell_spmv_batched", counts_b["sell_spmv_batched"],
                   cuda_b["sell_spmv_batched"], err_spmv_b, spmv_b_ms,
                   spmv_b_plain_ms, spmv_b_bnd, spmv_b_by, spmv_b_lib_ms),
        kernel_row("hbmc_trisolve", counts_idx["hbmc_trisolve"],
                   cuda_idx["hbmc_trisolve"], err_sw, sw_ms, sw_plain_ms,
                   sw_bnd, sw_by, sw_lib_ms),
        kernel_row("hbmc_trisolve_batched",
                   counts_idx_b["hbmc_trisolve_batched"],
                   cuda_idx_b["hbmc_trisolve_batched"], err_sw_b, sw_b_ms,
                   sw_b_plain_ms, sw_b_bnd, sw_b_by, sw_b_lib_ms),
    ]

    # -- 3f. mesh ---------------------------------------------------------------
    log(f"== 3f. mesh: build_plan(mesh=..., lane_multiple="
        f"{MESH_LANE_MULTIPLE}) at world size 1 "
        f"({'NCCL' if on_card else 'gloo'}), same matrix; solve and "
        f"solve_batched B={BATCH}")
    rows += mesh_phase(a_main, plan_kw, b, b8, iterations, on_card,
                       solve_reps)

    # -- 3g. analysis ---------------------------------------------------------
    log(f"== 3g. analysis: validate cheap / full / deep, kernel checks, "
        f"traffic, linters, a doctored cut, admission and the CLI, same "
        f"matrix (the mesh part ran in 3f)")
    analysis_phase(a_main, plan_kw, on_card)

    # -- 5. examples ----------------------------------------------------------
    log(f"== 5. examples: the twins of the five solver examples on "
        f"{device} against the CPU, then iccg_fem --scale {scale} on each "
        f"paper dataset")
    t0 = time.perf_counter()
    examples_phase(device, scale)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # -- 6. LM serving --------------------------------------------------------
    log("== 6. LM serving: the ten smoke configs on the card against the "
        "CPU (f32); mamba2-130m and qwen2.5-3b at their full configs")
    t0 = time.perf_counter()
    lm_phase(device, full=scale != "tiny")
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # -- 7. LM training -------------------------------------------------------
    log("== 7. LM training: the flash backward at qwen2.5-3b's shapes, the "
        "ten smoke configs on the card against the CPU (f32), the train_lm "
        "twin with a resume, and qwen2.5-3b at its full width")
    t0 = time.perf_counter()
    train_phase(device, full=scale != "tiny")
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # -- 8. the LM stack on a mesh --------------------------------------------
    log("== 8. the LM stack on a (1, 1) mesh: olmoe-1b-7b prefill and "
        "training sharded vs unsharded, the smoke configs, a reshard, and "
        "the dry-run")
    t0 = time.perf_counter()
    mesh_lm_phase(device, full=scale != "tiny")
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return rows


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
