"""Rank program of the port's multi-rank mesh tests (``test_torch_mesh.py``).

Spawned once per rank by ``torch.multiprocessing``; imports only
``repro_torch``, numpy and scipy (a spawned rank re-imports the module of
its target, so this one must not load JAX).  Every rank joins a gloo group
through a file store, builds the same mesh plan on the CPU, runs the same
solves (the SPMD contract) and writes what it got to ``rank<r>.npz``; the
test process compares the ranks with each other, with the port's
single-device plan and with the reference.  ``shard_apply`` runs a mesh
apply's shard steps on one device, for the CPU and card tests.
"""
import os

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


#: what one spawned run does: the solves of one method, a refactor round
#: trip, the static analysis of a mesh plan, or the rest
PARTS = METHODS + ("refactor", "iccg", "analysis")


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
