"""The port's mesh path on gloo CPU ranks, against the port's single-device
plan and the JAX reference.

Mirrors tests/test_distributed_plan.py (one rank, in this process) and the
plan parity of tests/test_multidevice.py (2 and 4 ranks, spawned; the rank
program is tests/_torch_mesh_worker.py, which loads no JAX).  System:
``laplace_2d(13, 17)``, ``block_size=8, w=4``, right-hand sides from numpy
seeds.  Tolerances: the mesh plan against the port's single-device plan
with the same ``lane_multiple`` is bitwise (same kernels' plain versions,
same per-lane arithmetic); against the reference, iteration counts equal
and solutions within rtol = atol = 1e-9 (PyTorch and XLA sum dots in
different orders); the shard step and ``sell_spmv_block`` against the JAX
kernels at the tolerance of tests/test_torch_kernels.py (f64 1e-12).

A one-rank group is made per module through a file store and destroyed at
the module's end; a multi-rank run joins its ranks with a 120 s timeout
that fails the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import _torch_mesh_worker as worker
from repro.core import build_plan as j_build_plan
from repro.core import pcg_iteration as j_pcg_iteration
from repro.core.iccg import make_sharded_spmv as j_make_sharded_spmv
from repro.core.iccg import spmv_sell as j_spmv_sell
from repro.core.trisolve import \
    DistributedRoundMajorPreconditioner as JDistributedPreconditioner
from repro.core.trisolve import shard_fused_tables as j_shard_fused_tables
from repro.kernels.sell_spmv import sell_spmv_block as j_sell_spmv_block
from repro_torch.core import (DistributedRoundMajorPreconditioner, build_plan,
                              device_loop, fused_solve, fused_solve_batched,
                              make_sharded_spmv, pcg, pcg_iteration,
                              shard_fused_tables)
from repro_torch.core import sell
from repro_torch.core.matrices import laplace_2d
from repro_torch.core.partition import (distributed_iccg,
                                        distributed_iccg_batched)
from repro_torch.kernels import (hbmc_trisolve_fused_batched_ref,
                                 hbmc_trisolve_fused_ref,
                                 hbmc_trisolve_shard_step,
                                 hbmc_trisolve_shard_step_batched,
                                 launch_counts, reset_launch_counts,
                                 sell_spmv, sell_spmv_batched,
                                 sell_spmv_block)

PLAN = dict(worker.PLAN, device="cpu")
RTOL = worker.RTOL
JOIN_SECONDS = 120
WORLDS = [2, 4]


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


def _jmesh1():
    return jax.make_mesh((1,), ("data",))


def _system():
    return worker.system()


# ---------------------------------------------------------------------------
# 1. One rank, in process: the mesh machinery == the single-device path.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["sell", "ell"])
@pytest.mark.parametrize("method", ["hbmc", "bmc"])
def test_mesh_plan_bitwise_on_one_device(mesh1, method, fmt):
    a, b, bb = _system()
    ref = build_plan(a, method=method, spmv_format=fmt, **PLAN)
    mp_ = build_plan(a, method=method, spmv_format=fmt, mesh=mesh1,
                     **worker.PLAN)
    assert mp_.device == torch.device("cpu") and mp_.lane_multiple == 1
    r_ref, r = ref.solve(b), mp_.solve(b)
    assert r.result.iterations == r_ref.result.iterations
    np.testing.assert_array_equal(r.x, r_ref.x)
    rb_ref, rb = ref.solve_batched(bb), mp_.solve_batched(bb)
    np.testing.assert_array_equal(rb.result.iterations,
                                  rb_ref.result.iterations)
    np.testing.assert_array_equal(rb.x, rb_ref.x)
    rs_ref, rs = ref.solve_slab(b, 3, slot=2), mp_.solve_slab(b, 3, slot=2)
    assert rs.result.iterations == rs_ref.result.iterations
    np.testing.assert_array_equal(rs.x, rs_ref.x)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_sharded_spmv_matches_reference(mesh1, fmt, batched):
    a = sp.csr_matrix(laplace_2d(12, 11))
    n = a.shape[0]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 3) if batched else n)
    if fmt == "ell":
        cols, vals = sell.pack_ell(a)
    else:
        sm = sell.pack_sell(a, 4)
        cols, vals = sm.cols, sm.vals
    f = make_sharded_spmv(fmt, n, mesh1, "data", torch.from_numpy(vals),
                          torch.from_numpy(cols.astype(np.int32)), batched)
    got = f(torch.from_numpy(x)).numpy()
    jf = j_make_sharded_spmv(fmt, n, _jmesh1(), "data", jnp.asarray(vals),
                             jnp.asarray(cols), batched=batched)
    want = np.asarray(jf(jnp.asarray(x)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="D"):
        f(torch.from_numpy(x[:, 0] if batched else x[:, None]))


def test_sharded_spmv_refuses_an_unknown_format(mesh1):
    z = torch.zeros(2, 1, 4)
    with pytest.raises(ValueError, match="unknown spmv format"):
        make_sharded_spmv("csr", 8, mesh1, "data", z, z.int(), False)


def _fused_pair(a):
    """The port's and the reference's round-major SELL plans of ``a`` (the
    same host setup, so the same tables)."""
    return (build_plan(a, method="hbmc", **PLAN),
            j_build_plan(a, method="hbmc", block_size=8, w=4,
                         spmv_format="sell"))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_distributed_preconditioner_matches_reference_and_fused_solve(
        mesh1, batched):
    a = laplace_2d(11, 9)
    plan, jplan = _fused_pair(a)
    t = plan._precond.tables
    dpre = DistributedRoundMajorPreconditioner(
        tables=shard_fused_tables(t, mesh1, "data"), mesh=mesh1)
    assert (dpre.n_rounds, dpre.lanes, dpre.m) == (
        t.n_steps, t.lanes, t.n_steps * t.lanes)
    rng = np.random.default_rng(3 + batched)
    r = rng.normal(size=(dpre.m, 2) if batched else dpre.m)
    got = (dpre.apply_batched if batched else dpre)(torch.from_numpy(r))
    q = torch.from_numpy(r).reshape((t.n_steps, t.lanes) + r.shape[1:])
    want = (fused_solve_batched if batched else fused_solve)(t, q)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jmesh = _jmesh1()
    jdpre = JDistributedPreconditioner(
        tables=j_shard_fused_tables(jplan._precond.tables, jmesh, "data"),
        mesh=jmesh, axis="data")
    jwant = (jdpre.apply_batched if batched else jdpre)(jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-12,
                               atol=1e-12)


def _round_major_operators(a):
    """(spmv, precond, b) of the port's and the reference's round-major
    plans of ``a`` on the same embedded right-hand side."""
    plan, jplan = _fused_pair(a)
    b = np.random.default_rng(6).normal(size=plan._rm.m)
    jv, jc, jn = jplan._spmv_vals, jplan._spmv_cols, jplan._spmv_n
    return (plan._spmv, plan._precond, torch.from_numpy(b)), \
        (lambda v: j_spmv_sell(jv, jc, v, jn), jplan._precond,
         jnp.asarray(b))


def test_pcg_iteration_reproduces_pcg_iterates():
    """The carried (x, r, p, rz) step replays the port's ``pcg`` bitwise;
    the (r, r) pairings of plain CG do not."""
    (spmv, pre, b), _ = _round_major_operators(laplace_2d(10, 9))
    k = 4
    ref = pcg(spmv, pre, b, rtol=0.0, maxiter=k)   # exactly k iterations
    assert ref.iterations == k
    step = pcg_iteration(spmv, pre)
    x, r = torch.zeros_like(b), b
    p = pre(r)
    rz = torch.dot(r, p)
    for _ in range(k):
        x, r, p, rz = step(x, r, p, rz)
    np.testing.assert_array_equal(x.numpy(), ref.x)

    xw, rw, pw = torch.zeros_like(b), b, pre(b)
    for _ in range(k):
        ap = spmv(pw)
        alpha = torch.dot(rw, rw) / torch.dot(pw, ap)
        xw, r2 = xw + alpha * pw, rw - alpha * ap
        z = pre(r2)
        pw = z + torch.dot(r2, z) / torch.dot(rw, rw) * pw
        rw = r2
    assert not np.allclose(xw.numpy(), ref.x, atol=1e-10)


def test_pcg_iteration_matches_reference():
    (spmv, pre, b), (jspmv, jpre, jb) = _round_major_operators(
        laplace_2d(10, 9))
    step, jstep = pcg_iteration(spmv, pre), j_pcg_iteration(jspmv, jpre)
    x, r, p = torch.zeros_like(b), b, pre(b)
    rz = torch.dot(r, p)
    jx, jr, jp = jnp.zeros_like(jb), jb, jpre(jb)
    jrz = jnp.vdot(jr, jp)
    for _ in range(5):
        x, r, p, rz = step(x, r, p, rz)
        jx, jr, jp, jrz = jstep(jx, jr, jp, jrz)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-9,
                                   atol=1e-9)
    np.testing.assert_allclose(float(rz), float(jrz), rtol=1e-9)


def test_mesh_plan_validation_errors(mesh1):
    a = laplace_2d(8, 8)
    with pytest.raises(ValueError, match="round_major"):
        build_plan(a, mesh=mesh1, layout="index")
    with pytest.raises(ValueError, match="axis 'model'"):
        build_plan(a, mesh=mesh1, mesh_axis="model")
    # the reference's backend= knob is no knob of the port
    with pytest.raises(TypeError, match="backend"):
        build_plan(a, mesh=mesh1, backend="pallas")
    with pytest.raises(ValueError, match="disagrees"):
        build_plan(a, mesh=mesh1, device="cuda")
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_plan(a, mesh=("data",), device="cpu")
    # an explicit device of the mesh's type is accepted
    assert build_plan(a, mesh=mesh1, device="cpu").mesh is mesh1


@pytest.mark.parametrize("mult", [3, 8])
def test_lane_multiple_pads_and_converges_identically(mult):
    a = laplace_2d(13, 11)
    b = np.random.default_rng(5).normal(size=a.shape[0])
    base = build_plan(a, method="hbmc", **PLAN)
    plan = build_plan(a, method="hbmc", lane_multiple=mult, **PLAN)
    assert plan._precond.tables.lanes % mult == 0
    assert plan._precond.tables.lanes > base._precond.tables.lanes
    r, rb = plan.solve(b), base.solve(b)
    # lane padding only adds inert lanes: the same Krylov process up to the
    # rounding of the dots over the padded vector
    assert abs(r.result.iterations - rb.result.iterations) <= 1
    np.testing.assert_allclose(r.x, rb.x, rtol=0, atol=1e-9)
    jr = j_build_plan(a, method="hbmc", block_size=8, w=4,
                      lane_multiple=mult).solve(b)
    assert r.result.iterations == jr.result.iterations


def test_distributed_iccg_on_one_rank(mesh1):
    a, b, bb = _system()
    rep = distributed_iccg(a, b, mesh1, rtol=RTOL, **worker.PLAN)
    want = build_plan(a, **PLAN).solve(b, rtol=RTOL)
    assert rep.n_padded > a.shape[0] and rep.x.shape == (a.shape[0],)
    np.testing.assert_array_equal(rep.x, want.x)
    rb = distributed_iccg_batched(a, bb, mesh1, rtol=RTOL, **worker.PLAN)
    want_b = build_plan(a, **PLAN).solve_batched(bb, rtol=RTOL)
    assert rb.x.shape == bb.shape
    np.testing.assert_array_equal(rb.x, want_b.x)
    assert rep.setup_seconds > 0


def test_mesh_plan_counts_its_collectives(mesh1):
    """A mesh solve issues 2S all-gathers per apply and one per SpMV, the
    shard step once per fused step, and no CPU launch is counted."""
    from repro_torch.core import mesh as mesh_mod
    a, b, _ = _system()
    plan = build_plan(a, mesh=mesh1, **worker.PLAN)
    mesh_mod.reset_gather_counts()
    device_loop.reset_loop_counts()
    reset_launch_counts()
    rep = plan.solve(b)
    k = device_loop._STEPS_PER_READ
    blocks = device_loop.loop_counts()["blocks"]
    assert blocks == -(-rep.result.iterations // k)
    applies = 1 + k * blocks
    assert mesh_mod.gather_counts() == {
        "trisolve": 2 * plan.n_rounds * applies, "spmv": k * blocks}
    assert set(launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# 2. The shard step and sell_spmv_block (plain versions on the CPU).
# ---------------------------------------------------------------------------

def _tables(a=None):
    plan = build_plan(laplace_2d(12, 10) if a is None else a, **PLAN)
    return plan._precond.tables


def _shard_apply(t, q, blocks: int):
    """``worker.shard_apply``, every replica the same; returns one."""
    ys = worker.shard_apply(t, q, blocks)
    for y in ys[1:]:
        torch.testing.assert_close(y, ys[0], rtol=0, atol=0)
    return ys[0]


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("nb", [None, 3], ids=["single", "B3"])
def test_shard_steps_are_the_fused_apply(nb, blocks):
    """The 2S shard steps of one lane block (or of two, gathered by hand)
    on a NaN-filled y are bitwise the fused apply: a forward step reads the
    slices not yet written as 0."""
    a = laplace_2d(12, 10)
    t = build_plan(a, lane_multiple=2, **PLAN)._precond.tables
    rng = np.random.default_rng(9)
    shape = (t.n_steps, t.lanes) + (() if nb is None else (nb,))
    q = torch.from_numpy(rng.normal(size=shape))
    got = _shard_apply(t, q, blocks)
    want = (hbmc_trisolve_fused_ref if nb is None else
            hbmc_trisolve_fused_batched_ref)(t.cols, t.vals, t.dinv, q)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_shard_step_batched_columns_are_single_columns():
    t = _tables()
    q = torch.from_numpy(np.random.default_rng(2).normal(
        size=(t.n_steps, t.lanes, 3)))
    got = _shard_apply(t, q, 1)
    for j in range(3):
        torch.testing.assert_close(
            got[:, j], _shard_apply(t, q[..., j].contiguous(), 1), rtol=0,
            atol=0)


def test_shard_step_checks_its_arguments():
    t = _tables()
    s_, r_ = t.n_steps, t.lanes
    q = torch.zeros(s_, r_, dtype=torch.float64)
    y = torch.zeros(s_ * r_, dtype=torch.float64)
    args = (t.cols, t.vals, t.dinv, q, y)
    with pytest.raises(ValueError, match="step"):
        hbmc_trisolve_shard_step(*args, 2 * s_, 0)
    with pytest.raises(ValueError, match="lanes"):
        hbmc_trisolve_shard_step(*args, 0, 1)
    with pytest.raises(ValueError, match="y shape"):
        hbmc_trisolve_shard_step(*args[:4], y[:-1], 0, 0)
    with pytest.raises(ValueError, match="rounds"):
        hbmc_trisolve_shard_step(*args[:3], q[:-1], y, 0, 0)
    with pytest.raises(ValueError, match="S, R, B"):
        hbmc_trisolve_shard_step_batched(*args, 0, 0)
    reset_launch_counts()
    hbmc_trisolve_shard_step(*args, 0, 0)
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize("nb", [None, 3], ids=["single", "B3"])
def test_sell_spmv_block_matches_reference_and_rows(nb):
    """A slice shard against the whole x: the rows of the whole product,
    and the reference's ``sell_spmv_block`` (interpret mode)."""
    plan = build_plan(laplace_2d(12, 11), **PLAN)
    sv, sc = plan._spmv_vals, plan._spmv_cols
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(sv.shape[0] * sv.shape[2],)
                                    + (() if nb is None else (nb,))))
    lo, hi = 2, sv.shape[0] - 1                 # a shard of the slices
    got = sell_spmv_block(sv[lo:hi].contiguous(), sc[lo:hi].contiguous(), x)
    whole = (sell_spmv if nb is None else sell_spmv_batched)(sv, sc, x)
    w = sv.shape[2]
    torch.testing.assert_close(got, whole[lo * w:hi * w], rtol=0, atol=0)
    want = j_sell_spmv_block(jnp.asarray(sv[lo:hi].numpy()),
                             jnp.asarray(sc[lo:hi].numpy()),
                             jnp.asarray(x.numpy()), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="x must be"):
        sell_spmv_block(sv, sc, x[None, None])


# ---------------------------------------------------------------------------
# 3. Two and four ranks, spawned.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world, part)``: spawn ``world`` gloo CPU ranks of
    ``_torch_mesh_worker.run_rank`` on ``part`` once per module; returns
    each rank's results.  A rank that fails, or a run that has not ended
    within ``JOIN_SECONDS``, fails the test."""
    done = {}

    def run(world: int, part: str) -> list[dict]:
        if (world, part) not in done:
            # a failed run fails every test that reads it, without a rerun
            done[world, part] = None
            done[world, part] = spawn(world, part)
        if done[world, part] is None:
            pytest.fail(f"the run of {world} ranks ({part}) failed")
        return done[world, part]

    def spawn(world: int, part: str) -> list[dict]:
        out = tmp_path_factory.mktemp(f"ranks{world}_{part}")
        try:
            return worker.spawn(world, part, str(out), JOIN_SECONDS)
        except TimeoutError as err:
            pytest.fail(str(err))

    return run


def _single_device(world: int, method: str):
    a, b, bb = _system()
    plan = build_plan(a, method=method, lane_multiple=world, **PLAN)
    return (plan.solve(b, rtol=RTOL), plan.solve_batched(bb, rtol=RTOL),
            plan.solve_slab(b, slab_width=3, slot=1, rtol=RTOL))


@pytest.mark.parametrize("method", worker.METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranks_bitwise_single_device_plan(spawned, world, method):
    """Counts and x of every rank are the port's single-device plan's with
    ``lane_multiple = world``: solve, solve_batched, solve_slab."""
    got = spawned(world, method)
    r, rb, rs = _single_device(world, method)
    for res in got:
        assert res["it"] == r.result.iterations
        np.testing.assert_array_equal(res["x"], r.x)
        np.testing.assert_array_equal(res["itb"], rb.result.iterations)
        np.testing.assert_array_equal(res["xb"], rb.x)
        assert res["its"] == rs.result.iterations
        np.testing.assert_array_equal(res["xs"], rs.x)


@pytest.mark.parametrize("method", worker.METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranks_match_reference(spawned, world, method):
    """Iteration counts equal the reference's single-device plan with the
    same ``lane_multiple``; solutions within 1e-9."""
    got = spawned(world, method)
    a, b, bb = _system()
    jp = j_build_plan(a, method=method, block_size=8, w=4,
                      lane_multiple=world)
    jr, jrb = jp.solve(b, rtol=RTOL), jp.solve_batched(bb, rtol=RTOL)
    assert jp._precond.tables.lanes == got[0]["lanes"] * world
    for res in got:
        assert res["it"] == jr.result.iterations
        np.testing.assert_array_equal(res["itb"], jrb.result.iterations)
        np.testing.assert_allclose(res["x"], jr.x, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(res["xb"], jrb.x, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", worker.METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranks_run_the_same_blocks(spawned, world, method):
    """Every rank ran the same number of blocks in each loop (the stop flag
    is computed from replicated state), ``ceil(trips / k)`` a loop."""
    got = spawned(world, method)
    k = device_loop._STEPS_PER_READ
    for key in ("blocks", "blocks_b", "blocks_s"):
        assert len({int(res[key]) for res in got}) == 1
    assert got[0]["blocks"] == -(-int(got[0]["it"]) // k)
    assert got[0]["blocks_b"] == -(-int(np.max(got[0]["itb"])) // k)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_refactor_round_trip(spawned, world):
    """``refactor`` to A + 0.37 diag(A) and back on every rank: setup_count
    counts the build and both refactors, as in the reference; the
    refactored solve is bitwise a cold mesh plan's, the way back the first
    solve's."""
    got = spawned(world, "refactor")
    for res in got:
        assert res["counts"].tolist() == [1, 3, 2]
        np.testing.assert_array_equal(res["moved"], res["cold"])
        np.testing.assert_array_equal(res["back"], res["first"])
        its = res["its"].tolist()
        assert its[0] == its[2] and its[1] == its[3]
        np.testing.assert_array_equal(res["moved"], got[0]["moved"])
    a, b, _ = _system()
    a2 = worker.perturbed(a)
    assert np.linalg.norm(a2 @ got[0]["moved"] - b) / np.linalg.norm(b) \
        < 1e-8


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranks_hold_their_blocks(spawned, world):
    """Rank i keeps lane block i of the fused tables and slice block i of
    the SELL operand (padded with zero slices to a multiple of the ranks);
    a lane axis that does not split over the ranks is refused."""
    got = spawned(world, "iccg")
    a, _, _ = _system()
    plan = build_plan(a, method="hbmc", lane_multiple=world, **PLAN)
    dinv = plan._precond.tables.dinv.numpy()
    vals = plan._spmv_vals.numpy()
    pad = (-vals.shape[0]) % world
    vals = np.concatenate([vals, np.zeros((pad,) + vals.shape[1:])])
    r_loc, s_loc = dinv.shape[1] // world, vals.shape[0] // world
    for i, res in enumerate(got):
        np.testing.assert_array_equal(res["dinv_block"],
                                      dinv[:, i * r_loc:(i + 1) * r_loc])
        np.testing.assert_array_equal(res["spmv_block"],
                                      vals[i * s_loc:(i + 1) * s_loc])
        assert f"lane_multiple={world}" in str(res["uneven_refused"])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_iccg_returns_caller_ordering(spawned, world):
    """``distributed_iccg`` returns x of shape (n,) in the caller's
    ordering on a system whose padded size exceeds n."""
    got = spawned(world, "iccg")
    a, b, _ = _system()
    for res in got:
        assert int(res["n_padded"]) > a.shape[0]
        assert res["x"].shape == (a.shape[0],)
        assert np.linalg.norm(a @ res["x"] - b) / np.linalg.norm(b) < 1e-8
        np.testing.assert_array_equal(res["x"], got[0]["x"])


def test_mesh_ranks_validate_and_prove_collectives(spawned):
    """Two ranks: ``build_plan(mesh=, validate="full")`` proves the whole
    tables and each rank's block; every rank's apply issues 2S all-gathers,
    its SpMV one, its solve no all-reduce, and its kernel checks are clean;
    a block that is the next rank's is witnessed as a shard mismatch."""
    got = spawned(2, "analysis")
    for res in got:
        assert res["found"].tolist() == []
        assert res["wrong"].tolist() == ["shard-mismatch"]
        assert int(res["n_rounds"]) == int(got[0]["n_rounds"])
