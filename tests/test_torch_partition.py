"""The index layout's mesh step of the port (``core/partition.py``
``shard_tables``, ``lower_solver_step``) and the validation of a built
mesh plan, on gloo CPU ranks, against the port's unsharded step and the
JAX reference.

System: the reference's ``test_solver_step_lowers_on_mesh`` one,
``laplace_2d(32, 32)``, HBMC block 8, w 4 (n = 1024, R = 64), ELL SpMV;
``_torch_mesh_worker.index_system``.  One rank runs in this process; 2 and
4 ranks are spawned (``_torch_mesh_worker.py`` part ``partition``, joined
within 120 s).  Tolerances: the mesh step against the port's unsharded
``pcg_iteration`` over ``forward_solve`` / ``backward_solve`` bitwise (the
per-lane arithmetic is the same, the products summed in k order); the
port's unsharded step against the reference's rel 1e-12 in the 2-norm of
each state vector (f64: PyTorch and XLA sum the dots in different orders);
lane blocks bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import _torch_mesh_worker as worker
from repro.core import pcg_iteration as j_pcg_iteration
from repro.core.iccg import spmv_ell as j_spmv_ell
from repro.core.trisolve import DeviceTables as JDeviceTables
from repro.core.trisolve import backward_solve as j_backward_solve
from repro.core.trisolve import forward_solve as j_forward_solve
from repro_torch.analysis import validate_plan
from repro_torch.core import (DeviceTables, backward_solve, build_plan,
                              forward_solve, pcg_iteration, spmv_ell)
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.matrices import laplace_2d
from repro_torch.core.partition import (_lane_block, _pad_lanes,
                                        lower_solver_step, shard_tables)

JOIN_SECONDS = 120
WORLDS = [2, 4]
MODES = ("cheap", "full", "deep")
FIELDS = ("rows", "cols", "vals", "dinv")


# first in the module: it makes and destroys its own group before the
# module's one-rank group exists
def test_built_mesh_plan_validation_needs_its_group(tmp_path):
    """Without its process group a built mesh plan cannot gather its
    tables: "full" raises and says so; "cheap" needs no tables."""
    assert not dist.is_initialized(), "a process group leaked in"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        plan = build_plan(laplace_2d(13, 11), method="hbmc", mesh=mesh,
                          block_size=8, w=4)
    finally:
        dist.destroy_process_group()
    assert validate_plan(plan, "cheap") == []
    with pytest.raises(ValueError, match="process group is gone"):
        validate_plan(plan, "full")


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo group and its ``("data",)`` mesh, destroyed at the
    module's end."""
    assert not dist.is_initialized(), "a process group leaked in"
    store = tmp_path_factory.mktemp("mesh1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world)``: the ``partition`` part on ``world`` spawned gloo
    ranks, once per module; each rank's results."""
    done = {}

    def run(world: int) -> list[dict]:
        if world not in done:
            done[world] = None
            out = tmp_path_factory.mktemp(f"partition{world}")
            try:
                done[world] = worker.spawn(world, "partition", str(out),
                                           JOIN_SECONDS)
            except TimeoutError as err:
                pytest.fail(str(err))
        if done[world] is None:
            pytest.fail(f"the run of {world} ranks failed")
        return done[world]
    return run


@pytest.fixture(scope="module")
def system():
    return worker.index_system()


def _unsharded_states(system) -> np.ndarray:
    """The port's unsharded step, ``SOLVER_STEPS`` times from
    ``first_state``: each state flattened, (steps, 3n + 1)."""
    fwd, bwd, cols, vals = system
    step = pcg_iteration(lambda v: spmv_ell(vals, cols, v),
                         lambda v: backward_solve(bwd, forward_solve(fwd, v)))
    state, out = worker.first_state(fwd, bwd), []
    for _ in range(worker.SOLVER_STEPS):
        state = step(*state)
        out.append(torch.cat([t.reshape(-1) for t in state]).numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def unsharded(system):
    return _unsharded_states(system)


# ---------------------------------------------------------------------------
# shard_tables: lane blocks of the padded tables.
# ---------------------------------------------------------------------------

def _tables(which: str, system):
    fwd, bwd, _, _ = system
    t = bwd if which == "bwd" else fwd
    if which == "odd":      # R = 61: padded at every size but 1
        t = DeviceTables(*(getattr(t, f)[:, :61] for f in FIELDS),
                         n_slots=t.n_slots)
    return t


@pytest.mark.parametrize("which", ["fwd", "bwd", "odd"])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_lane_blocks_concatenate_to_the_padded_tables(system, which, size):
    t = _tables(which, system)
    padded = _pad_lanes(t, size)
    r = t.dinv.shape[1]
    assert padded.dinv.shape[1] == r + (-r) % size
    blocks = [_lane_block(t, size, i) for i in range(size)]
    for f in FIELDS:
        whole = torch.cat([getattr(b, f) for b in blocks], dim=1)
        assert torch.equal(whole, getattr(padded, f)), f
        assert torch.equal(whole[:, :r], getattr(t, f)), f
        assert all(getattr(b, f).is_contiguous() for b in blocks)
    scratch = t.n_slots - 1
    assert (padded.rows[:, r:] == scratch).all()
    assert (padded.cols[:, r:] == scratch).all()
    assert (padded.vals[:, r:] == 0).all() and (padded.dinv[:, r:] == 0).all()


@pytest.mark.parametrize("size", [2, 3, 4])
def test_pad_lanes_are_inert(system, size):
    """Pad lanes write +0 into the scratch slot only: both sweeps over the
    padded tables are bitwise the sweeps over the tables."""
    fwd, bwd, _, _ = system
    q = torch.tensor(np.random.default_rng(size).normal(
        size=fwd.n_slots - 1))
    y = forward_solve(fwd, q)
    assert torch.equal(forward_solve(_pad_lanes(fwd, size), q), y)
    assert torch.equal(backward_solve(_pad_lanes(bwd, size), y),
                       backward_solve(bwd, y))


def test_shard_tables_on_one_rank_keeps_the_tables(mesh1, system):
    fwd = system[0]
    block = shard_tables(fwd, mesh1)
    assert block.n_slots == fwd.n_slots
    for f in FIELDS:
        assert torch.equal(getattr(block, f), getattr(fwd, f))


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_keep_their_lane_blocks(spawned, system, world):
    """Rank i's ``shard_tables`` of the R = 61 table is lane block i of
    the tables padded to a multiple of the ranks."""
    want = _pad_lanes(_tables("odd", system), world)
    got = spawned(world)
    for f in FIELDS:
        whole = np.concatenate([res[f"block_{f}"] for res in got], axis=1)
        np.testing.assert_array_equal(whole, getattr(want, f).numpy())


# ---------------------------------------------------------------------------
# lower_solver_step: one PCG iteration on the mesh.
# ---------------------------------------------------------------------------

def test_solver_step_is_the_unsharded_step_on_one_rank(mesh1, system,
                                                       unsharded):
    fwd, bwd, cols, vals = system
    step = lower_solver_step(fwd, bwd, cols, vals, mesh1)
    n_steps = fwd.rows.shape[0] + bwd.rows.shape[0]
    assert (step.sweep_steps, step.gathers_per_iteration) == \
        (n_steps, n_steps + 1) == (32, 33)
    state = worker.first_state(fwd, bwd)
    mesh_mod.reset_gather_counts()
    for i in range(worker.SOLVER_STEPS):
        state = step.step(*state)
        flat = torch.cat([t.reshape(-1) for t in state]).numpy()
        np.testing.assert_array_equal(flat, unsharded[i])
    assert mesh_mod.gather_counts() == {
        "trisolve": n_steps * worker.SOLVER_STEPS,
        "spmv": worker.SOLVER_STEPS}
    assert step.graph is None               # nothing is captured on the CPU
    assert [b.dinv.shape for b in step.tables] == [fwd.dinv.shape,
                                                   bwd.dinv.shape]


@pytest.mark.parametrize("world", WORLDS)
def test_solver_step_on_ranks_is_bitwise_the_unsharded_step(
        spawned, unsharded, world):
    """Every rank's iterates are the port's unsharded step's, bitwise; each
    iteration issued S + S sweep all-gathers and one SpMV all-gather."""
    for res in spawned(world):
        np.testing.assert_array_equal(res["states"], unsharded)
        assert res["counts"].tolist() == [32, 33]
        assert res["gathers"].tolist() == [32 * worker.SOLVER_STEPS,
                                           worker.SOLVER_STEPS]
        assert bool(res["no_graph"])        # nothing captured on the CPU


def test_unsharded_step_matches_the_reference(system, unsharded):
    """The port's step, rel 1e-12 of the reference's ``pcg_iteration`` over
    its ``forward_solve`` / ``backward_solve`` on the same tables."""
    fwd, bwd, cols, vals = system

    def jt(t):
        return JDeviceTables(rows=jnp.asarray(t.rows.numpy()),
                             cols=jnp.asarray(t.cols.numpy()),
                             vals=jnp.asarray(t.vals.numpy()),
                             dinv=jnp.asarray(t.dinv.numpy()),
                             n_slots=t.n_slots)

    jf, jb = jt(fwd), jt(bwd)
    jc, jv = jnp.asarray(cols.numpy()), jnp.asarray(vals.numpy())
    step = jax.jit(j_pcg_iteration(
        lambda v: j_spmv_ell(jv, jc, v),
        lambda v: j_backward_solve(jb, j_forward_solve(jf, v))))
    state = tuple(jnp.asarray(t.numpy())
                  for t in worker.first_state(fwd, bwd))
    n = fwd.n_slots - 1
    for i in range(worker.SOLVER_STEPS):
        state = step(*state)
        for k, got in enumerate(state):
            want = unsharded[i][k * n:(k + 1) * n] if k < 3 else \
                unsharded[i][3 * n:]
            got = np.atleast_1d(np.asarray(got))
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel < 1e-12, (i, k, rel)


@pytest.mark.parametrize("world", WORLDS)
def test_solver_step_refuses_an_n_or_r_that_does_not_split(spawned, world):
    for res in spawned(world):
        lanes, rows = res["refused"].tolist()
        assert f"R = 61 lanes, not a multiple of mesh axis 'data' ({world})"\
            in lanes
        assert f"n = 1023 is not a multiple of mesh axis 'data' ({world})" \
            in rows


def test_solver_step_refuses_tables_of_another_system(mesh1, system):
    fwd, bwd, cols, vals = system
    with pytest.raises(ValueError, match="one system"):
        lower_solver_step(fwd, bwd, cols[:-1], vals[:-1], mesh1)
    other = dataclasses.replace(bwd, n_slots=bwd.n_slots + 1)
    with pytest.raises(ValueError, match="one system"):
        lower_solver_step(fwd, other, cols, vals, mesh1)


# ---------------------------------------------------------------------------
# validate_plan on a built mesh plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_built_mesh_plan_validates_on_ranks(spawned, world):
    """Every rank's ``validate_plan(built mesh plan, m)`` is ``[]`` in each
    mode; with lane 0 of rank 0's block doctored, every rank returns the
    witnesses the single-device plan gives on the same doctored whole
    table."""
    a, _, _ = worker.system()
    single = build_plan(a, method="hbmc", lane_multiple=world, device="cpu",
                        **worker.PLAN)
    worker.doctor(single._precond.tables, 0, single._precond.tables.lanes)
    want = [str(v) for v in validate_plan(single, "full")]
    assert any("premature-read" in w for w in want)
    for res in spawned(world):
        assert res["verdicts"].tolist() == ["[]"] * len(MODES)
        assert res["doctored"].tolist() == want

