"""Rank program of the port's multi-rank mesh tests (``test_torch_mesh.py``).

Spawned once per rank by ``torch.multiprocessing``; imports only
``repro_torch``, numpy and scipy (a spawned rank re-imports the module of
its target, so this one must not load JAX).  Every rank joins a gloo group
through a file store, builds the same mesh plan on the CPU, runs the same
solves (the SPMD contract) and writes what it got to ``rank<r>.npz``; the
test process compares the ranks with each other, with the port's
single-device plan and with the reference.  ``shard_apply`` runs a mesh
apply's shard steps on one device, for the CPU and card tests; ``spawn``
runs one part on spawned ranks for the tests' fixtures; ``index_system``
and ``first_state`` give the index-layout mesh step its system.
"""
import os
import time

import numpy as np
import scipy.sparse as sp

PLAN = dict(block_size=8, w=4)
RTOL = 1e-9
METHODS = ("hbmc", "bmc")


def system():
    """laplace_2d(13, 17) (n = 221: padding in every ordering), one RHS and
    three, from default_rng(0)."""
    from repro_torch.core.matrices import laplace_2d
    a = laplace_2d(13, 17)
    rng = np.random.default_rng(0)
    return a, rng.normal(size=a.shape[0]), rng.normal(size=(a.shape[0], 3))


def perturbed(a):
    """A + 0.37 diag(A): the refactor target."""
    return (a + 0.37 * sp.diags(a.diagonal())).tocsr()


def shard_apply(t, q, blocks: int, fill: float = float("nan")):
    """The fused apply of tables ``t`` (``DeviceFusedTables``) as
    ``blocks`` lane blocks, one shard step per step and block, each block
    on its own replica of y (filled with ``fill``: a forward step must
    read the slices not yet written as 0), each step's block entries
    copied to every replica by hand (a mesh's all-gather, on one device).
    Returns the replicas."""
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


def index_system(device: str = "cpu"):
    """The reference's ``test_solver_step_lowers_on_mesh`` system:
    ``laplace_2d(32, 32)``, HBMC with block 8 and w 4 (n = 1024, R = 64),
    its index-layout forward and backward ``DeviceTables`` and its (n, K)
    ELL operand as tensors: (fwd, bwd, ell cols, ell vals)."""
    import torch

    from repro_torch.core import (DeviceTables, block_multicolor_ordering,
                                  hbmc_from_bmc, ic0, pack_factor_hbmc,
                                  pad_system_hbmc)
    from repro_torch.core.matrices import laplace_2d
    from repro_torch.core.sell import pack_ell
    a = laplace_2d(32, 32)
    hb = hbmc_from_bmc(block_multicolor_ordering(a, 8), 4)
    a_hb, _ = pad_system_hbmc(a, None, hb)
    fwd_h, bwd_h = pack_factor_hbmc(ic0(a_hb), hb)
    cols, vals = pack_ell(a_hb)
    return (DeviceTables.from_host(fwd_h, device=device),
            DeviceTables.from_host(bwd_h, device=device),
            torch.tensor(cols, device=device),
            torch.tensor(vals, device=device))


def first_state(fwd, bwd, seed: int = 5):
    """PCG's state before its first iteration, (x, r, p, rz), for b from
    ``default_rng(seed)``, on the tables' device: x = 0, r = b, p = z =
    M^-1 r, rz = (r, z)."""
    import torch

    from repro_torch.core import backward_solve, forward_solve
    b = np.random.default_rng(seed).normal(size=fwd.n_slots - 1)
    r = torch.tensor(b, device=fwd.vals.device)
    z = backward_solve(bwd, forward_solve(fwd, r))
    return torch.zeros_like(r), r, z, torch.dot(r, z)


#: iterations of the index-layout mesh step the tests run
SOLVER_STEPS = 5

#: what one spawned run does: the solves of one method, a refactor round
#: trip, the static analysis of a mesh plan, the index-layout mesh step with
#: the validation of a built mesh plan, or the rest
PARTS = METHODS + ("refactor", "iccg", "analysis", "partition")


def spawn(world: int, part: str, out_dir: str,
          timeout: float) -> list[dict]:
    """Run ``part`` on ``world`` spawned gloo ranks; returns each rank's
    results.  Raises ``TimeoutError`` when the run has not ended within
    ``timeout`` seconds (its ranks are killed), and what
    ``torch.multiprocessing`` raises when a rank fails."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(run_rank,
                             args=(world, os.path.join(out_dir, "store"),
                                   out_dir, part),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks ({part}) did not end "
                                   f"within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


def run_rank(rank: int, world: int, store: str, out_dir: str,
             part: str) -> None:
    """One rank's share of ``part`` (``PARTS``): each part is its own
    spawned run, so that each stays well inside the tests' join timeout
    on a loaded host (a gloo all-gather waits for every rank to be
    scheduled)."""
    # loopback only, and one thread a rank: the ranks share the host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        got = (_solves(mesh, part) if part in METHODS else
               _refactor(mesh) if part == "refactor" else
               _analysis(mesh, world) if part == "analysis" else
               _partition(mesh, world) if part == "partition" else
               _iccg(mesh, world))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()


def _solves(mesh, method: str) -> dict:
    """solve, solve_batched and solve_slab of one method's mesh plan, with
    the loop blocks each ran."""
    from repro_torch.core import build_plan, device_loop
    a, b, bb = system()
    plan = build_plan(a, method=method, mesh=mesh, **PLAN)
    got = {"lanes": plan._precond.tables.lanes}
    device_loop.reset_loop_counts()
    rep = plan.solve(b, rtol=RTOL)
    got.update(blocks=device_loop.loop_counts()["blocks"], x=rep.x,
               it=rep.result.iterations)
    device_loop.reset_loop_counts()
    rb = plan.solve_batched(bb, rtol=RTOL)
    got.update(blocks_b=device_loop.loop_counts()["blocks"], xb=rb.x,
               itb=rb.result.iterations)
    device_loop.reset_loop_counts()
    rs = plan.solve_slab(b, slab_width=3, slot=1, rtol=RTOL)
    got.update(blocks_s=device_loop.loop_counts()["blocks"], xs=rs.x,
               its=rs.result.iterations)
    return got


def _refactor(mesh) -> dict:
    """``refactor`` there and back: setup_count as the reference counts
    it, the refactored solve bitwise a cold plan's."""
    from repro_torch.core import build_plan
    a, b, _ = system()
    plan = build_plan(a, method="hbmc", mesh=mesh, **PLAN)
    first = plan.solve(b, rtol=RTOL)
    count = plan.setup_count
    plan.refactor(perturbed(a))
    moved = plan.solve(b, rtol=RTOL)
    plan.refactor(a)
    back = plan.solve(b, rtol=RTOL)
    cold = build_plan(perturbed(a), method="hbmc", mesh=mesh,
                      **PLAN).solve(b, rtol=RTOL)
    return dict(counts=np.array([count, plan.setup_count,
                                 plan.refactor_count]),
                first=first.x, moved=moved.x, back=back.x, cold=cold.x,
                its=np.array([first.result.iterations,
                              moved.result.iterations,
                              back.result.iterations,
                              cold.result.iterations]))


def _iccg(mesh, world: int) -> dict:
    """This rank's operand blocks, the refusal of an uneven lane axis, and
    ``distributed_iccg``."""
    import torch

    from repro_torch.core import (DeviceFusedTables, build_plan,
                                  shard_fused_tables)
    from repro_torch.core.partition import distributed_iccg
    a, b, _ = system()
    plan = build_plan(a, method="hbmc", mesh=mesh, **PLAN)
    got = dict(dinv_block=plan._precond.tables.dinv.numpy(),
               spmv_block=plan._spmv_vals.numpy())
    # a lane axis that does not split over the ranks is refused
    lanes = world + 1
    odd = DeviceFusedTables(
        cols=torch.zeros(2, lanes, 1, dtype=torch.int32),
        vals=torch.zeros(2, lanes, 1, dtype=torch.float64),
        dinv=torch.zeros(2, lanes, dtype=torch.float64))
    try:
        shard_fused_tables(odd, mesh, "data")
        got["uneven_refused"] = ""
    except ValueError as err:
        got["uneven_refused"] = str(err)
    rep = distributed_iccg(a, b, mesh, rtol=RTOL, **PLAN)
    got.update(x=rep.x, n_padded=rep.n_padded)
    return got


def _analysis(mesh, world: int) -> dict:
    """``build_plan(validate="full")`` on a mesh plan (the whole tables
    proven before they are sharded, the rank's block checked against them),
    the collective structure and kernel checks of the plan, and the
    witness of a block that is another rank's."""
    import torch.distributed as dist

    from repro_torch.analysis import (check_plan_collectives,
                                      check_plan_kernels, check_shard_block)
    from repro_torch.core import DeviceFusedTables, build_plan
    a, _, _ = system()
    plan = build_plan(a, method="hbmc", mesh=mesh, validate="full", **PLAN)
    found = check_plan_collectives(plan) + check_plan_kernels(plan)
    whole = build_plan(a, method="hbmc", lane_multiple=world, device="cpu",
                       **PLAN)._precond.tables
    r_loc = whole.lanes // world
    nxt = (dist.get_rank() + 1) % world
    lanes = slice(nxt * r_loc, (nxt + 1) * r_loc)
    other = DeviceFusedTables(cols=whole.cols[:, lanes].contiguous(),
                              vals=whole.vals[:, lanes].contiguous(),
                              dinv=whole.dinv[:, lanes].contiguous())
    wrong = check_shard_block(whole, other, mesh, "data")
    return dict(found=np.array([str(v) for v in found], dtype=str),
                wrong=np.array([v.kind for v in wrong], dtype=str),
                n_rounds=plan.n_rounds)


def doctor(tables, lane: int, lanes: int) -> int:
    """Make fused step 1, lane ``lane`` of ``tables`` (a rank's block or
    the whole tables; the whole tables have ``lanes`` lanes) read its own
    slot: a premature read that "full" validation witnesses.  Returns the
    round-major position read."""
    g = 1
    tables.cols[g, lane, 0] = g * lanes + lane
    tables.vals[g, lane, 0] = 1.0
    return g * lanes + lane


def _partition(mesh, world: int) -> dict:
    """The index-layout mesh step (``lower_solver_step``: its iterates,
    counts and all-gathers; ``shard_tables`` on an R that does not split;
    the refusal of an n or R that does not split), then ``validate_plan``
    on a built mesh plan in each mode, clean and with lane 0 of rank 0's
    block doctored."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import validate_plan
    from repro_torch.core import DeviceTables, build_plan
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core.partition import lower_solver_step, shard_tables
    fwd, bwd, cols, vals = index_system()
    step = lower_solver_step(fwd, bwd, cols, vals, mesh)
    state = first_state(fwd, bwd)
    mesh_mod.reset_gather_counts()
    states = []
    for _ in range(SOLVER_STEPS):
        state = step.step(*state)
        states.append(torch.cat([t.reshape(-1) for t in state]).numpy())
    gathers = mesh_mod.gather_counts()
    odd = DeviceTables(rows=fwd.rows[:, :61], cols=fwd.cols[:, :61],
                       vals=fwd.vals[:, :61], dinv=fwd.dinv[:, :61],
                       n_slots=fwd.n_slots)
    block = shard_tables(odd, mesh)
    # an R of 61 lanes, and n = 1023 unknowns (tables and an ELL operand
    # that agree on it)
    short = [DeviceTables(rows=t.rows, cols=t.cols, vals=t.vals,
                          dinv=t.dinv, n_slots=t.n_slots - 1)
             for t in (fwd, bwd)]
    refused = []
    for tabs in ((odd, odd, cols, vals),
                 (*short, cols[:-1], vals[:-1])):
        try:
            lower_solver_step(*tabs, mesh)
            refused.append("")
        except ValueError as err:
            refused.append(str(err))

    a, _, _ = system()
    plan = build_plan(a, method="hbmc", mesh=mesh, **PLAN)
    verdicts = [str(validate_plan(plan, m)) for m in
                ("cheap", "full", "deep")]
    if dist.get_rank() == 0:
        doctor(plan._precond.tables, 0, plan._precond.lanes)
    doctored = [str(v) for v in validate_plan(plan, "full")]
    return dict(states=np.stack(states),
                gathers=np.array([gathers["trisolve"], gathers["spmv"]]),
                counts=np.array([step.sweep_steps,
                                 step.gathers_per_iteration]),
                no_graph=np.array(step.graph is None),
                block_rows=block.rows.numpy(), block_cols=block.cols.numpy(),
                block_vals=block.vals.numpy(),
                block_dinv=block.dinv.numpy(),
                refused=np.array(refused, dtype=str),
                verdicts=np.array(verdicts, dtype=str),
                doctored=np.array(doctored, dtype=str))
