"""The LM stack on a mesh, on gloo CPU ranks: the explicit-dispatch MoE
(``models/moe_shardmap.py``), a sharded ``train_step`` and the elastic
checkpoint reshard, against the port's unsharded results and the JAX
reference's.

The ranks are spawned as tests/test_torch_mesh.py spawns them (the rank
program is tests/_torch_lm_mesh_worker.py, which loads no JAX); each run
is joined with a timeout that fails the test.  The reference's sharded
paths (``test_multidevice.py::test_pjit_train_step_matches_unsharded``,
``::test_shardmap_moe_grads_match_plain``) fail in the reference, so the
oracle is the reference's **unsharded** step and ``moe_apply``.

Tolerances (f32), each times max(1, max |want|) of the tensor compared:
the MoE's outputs and gradients within 1e-5 of ``moe_apply``'s (the
port's and the reference's; an expert weight's gradient sums 64 tokens'
terms and reaches ~10, where the two data shards' partial sums round
apart by ~1e-6 of it); a sharded step's loss within 1e-5 and its new
parameters within 1e-4 of the port's unsharded step and of the
reference's unsharded step.  The reshard is bitwise.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import _torch_lm_mesh_worker as worker
from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro.models.moe import moe_apply as j_moe_apply
from repro.train import step as j_step
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch import dist as D
from repro_torch.models.convert import params_from_reference
from repro_torch.models.moe_shardmap import moe_apply_shardmap

JOIN_SECONDS = 240
MOE_TOL = 1e-5
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4


def _train_inputs() -> dict:
    """The reference's smoke weights of each train arch (f32, PRNGKey(0))
    in the port's names, and a batch from ``default_rng``."""
    out = {}
    rng = np.random.default_rng(3)
    for arch in worker.TRAIN_ARCHS:
        jcfg = jconfigs.get_smoke_config(arch)
        params = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        state = params_from_reference(jax.tree.map(np.asarray, params), jcfg)
        out.update({f"{arch}.param.{k}": v.numpy() for k, v in state.items()})
        tokens = rng.integers(0, jcfg.vocab, worker.TRAIN_BATCH + (1,))
        out[f"{arch}.inputs"] = tokens[..., 0].astype(np.int32)
        out[f"{arch}.labels"] = rng.integers(
            0, jcfg.vocab, worker.TRAIN_BATCH).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def lm_run(tmp_path_factory):
    """One spawned world-4 run of the ``"lm"`` part: rank 0's results (the
    ranks' whole tensors agree; checked below) and the inputs."""
    out_dir = str(tmp_path_factory.mktemp("lm_mesh"))
    inputs = _train_inputs()
    np.savez(f"{out_dir}/inputs.npz", **inputs)
    ranks = worker.spawn(4, "lm", out_dir, JOIN_SECONDS)
    return ranks, inputs


def _close(got, want, tol, what):
    """max |got - want| <= tol x max(1, max |want|)."""
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


def test_ranks_agree(lm_run):
    """Every rank holds the same whole tensors (SPMD)."""
    ranks, _ = lm_run
    for r in ranks[1:]:
        assert set(r) == set(ranks[0])
        for k, v in r.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


def _ref_moe(mi, cf):
    """The reference's ``moe_apply`` and its gradients on the worker's
    MoE inputs."""
    p = {"router": jnp.asarray(mi["router"]),
         "experts": {k: jnp.asarray(mi[k]) for k in ("gate", "up", "down")}}

    def f(p, x):
        y, logits = j_moe_apply(p, x, top_k=worker.MOE["top_k"],
                                capacity_factor=cf, act="silu")
        return (jnp.sum(y * mi["gy"]) + jnp.sum(logits * mi["glogits"]),
                (y, logits))
    (_, (y, logits)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(p, jnp.asarray(mi["x"]))
    out = {"y": y, "logits": logits, "grad.x": gx,
           "grad.router": gp["router"]}
    out.update({f"grad.experts.{k}": v for k, v in gp["experts"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("shape", worker.MOE_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_shardmap_matches_moe_apply(lm_run, shape):
    """Exact capacity: ``moe_apply_shardmap`` on the mesh equals the
    port's ``moe_apply`` and the reference's, outputs and gradients of x,
    the router and every expert weight, within 1e-5; it engaged."""
    ranks, _ = lm_run
    got = ranks[0]
    tag = f"moe.{shape[0]}x{shape[1]}.cf0.0"
    assert int(got[f"{tag}.engaged"]) == 1
    ref = _ref_moe(worker.moe_inputs(), 0.0)
    for k, want in ref.items():
        _close(got[f"{tag}.sharded.{k}"], got[f"{tag}.plain.{k}"], MOE_TOL,
               f"{tag} {k} vs the port's moe_apply")
        _close(got[f"{tag}.sharded.{k}"], want, MOE_TOL,
               f"{tag} {k} vs the reference's moe_apply")


def test_moe_shardmap_routes_per_batch_shard(lm_run):
    """With a capacity (factor 1.25) the routing is batch-local, as the
    reference's: unsharded over the batch, (1, 4), it equals
    ``moe_apply``; on (2, 2) each data shard's tokens are routed on their
    own, so it equals the reference's ``moe_apply`` on each half, and the
    capacity drops make it differ from the whole batch's."""
    ranks, _ = lm_run
    got = ranks[0]
    mi = worker.moe_inputs()
    whole = _ref_moe(mi, 1.25)
    tag = "moe.1x4.cf1.25"
    for k in ("y", "logits", "grad.x", "grad.router"):
        _close(got[f"{tag}.sharded.{k}"], whole[k], MOE_TOL, f"{tag} {k}")
    tag = "moe.2x2.cf1.25"
    half = worker.MOE["batch"][0] // 2
    t_half = half * worker.MOE["batch"][1]
    for i in range(2):
        part = dict(mi, x=mi["x"][i * half:(i + 1) * half],
                    gy=mi["gy"][i * half:(i + 1) * half],
                    glogits=mi["glogits"][i * t_half:(i + 1) * t_half])
        ref = _ref_moe(part, 1.25)
        _close(got[f"{tag}.sharded.y"][i * half:(i + 1) * half], ref["y"],
               MOE_TOL, f"{tag} y, half {i}")
        _close(got[f"{tag}.sharded.grad.x"][i * half:(i + 1) * half],
               ref["grad.x"], MOE_TOL, f"{tag} grad x, half {i}")
    assert np.max(np.abs(got[f"{tag}.sharded.y"] - whole["y"])) > 1e-3


def _ref_step(arch, inputs):
    """The reference's unsharded ``train_step``: (loss, new parameters in
    the port's names)."""
    jcfg = jconfigs.get_smoke_config(arch)
    params = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = {k: jnp.asarray(inputs[f"{arch}.{k}"])
             for k in ("inputs", "labels")}
    new, _, m = j_step.train_step(
        params, j_init_opt_state(params), batch, cfg=jcfg,
        opt_cfg=JAdamWConfig(lr=worker.LR, total_steps=10, warmup_steps=1))
    state = params_from_reference(jax.tree.map(np.asarray, new), jcfg)
    return float(m["loss"]), {k: v.numpy() for k, v in state.items()}


@pytest.mark.parametrize("arch", worker.TRAIN_ARCHS)
def test_sharded_train_step_matches_unsharded(lm_run, arch):
    """One ``train_step`` with the parameters placed by
    ``params_shardings`` and the batch by ``batch_partition_spec`` on the
    (2, 2) mesh: the loss within 1e-5 and every new parameter within 1e-4
    of the port's unsharded step and of the reference's unsharded step;
    the MoE arch took the explicit dispatch."""
    ranks, inputs = lm_run
    got = ranks[0]
    ref_loss, ref_params = _ref_step(arch, inputs)
    sh, plain = f"{arch}.sharded", f"{arch}.plain"
    assert abs(float(got[f"{sh}.loss"]) - float(got[f"{plain}.loss"])) \
        <= LOSS_TOL
    assert abs(float(got[f"{sh}.loss"]) - ref_loss) <= LOSS_TOL
    names = [k[len(sh) + 7:] for k in got if k.startswith(f"{sh}.param.")]
    assert sorted(names) == sorted(ref_params)
    for n in names:
        g = got[f"{sh}.param.{n}"]
        _close(g, got[f"{plain}.param.{n}"], PARAM_TOL, f"{arch} {n} vs port")
        _close(g, ref_params[n], PARAM_TOL, f"{arch} {n} vs reference")
    moe = jconfigs.get_smoke_config(arch).n_experts > 0
    assert (int(got[f"{sh}.engaged"]) > 0) == moe
    assert int(got[f"{plain}.engaged"]) == 0


def test_elastic_reshard(tmp_path):
    """A checkpoint of leaves sharded on a (2,) mesh restores onto a (1, 2)
    mesh with other placements (``load_checkpoint(shardings=)``), the
    whole tensors bitwise the saved ones (f32, bf16, int32)."""
    ranks = worker.spawn(2, "reshard", str(tmp_path), JOIN_SECONDS)
    for rank, got in enumerate(ranks):
        assert int(got["step"]) == 3
        for key in ("w", "opt0", "opt1"):
            np.testing.assert_array_equal(got[f"{key}.whole"],
                                          got[f"{key}.want"])
            assert str(got[f"{key}.placements"]) == "(Replicate(), Shard(dim=1))"
            whole = got[f"{key}.whole"]
            if whole.dtype == np.int16:
                whole = torch.from_numpy(whole).view(torch.bfloat16).float() \
                    .numpy()
            cols = whole.shape[-1] // 2
            np.testing.assert_array_equal(
                got[f"{key}.local"], whole[..., rank * cols:(rank + 1) * cols])


@pytest.fixture
def one_rank(tmp_path):
    assert not dist.is_initialized(), "a process group leaked in"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_moe_shardmap_declines_where_the_reference_does(one_rank):
    """None without an active mesh, without a "model" axis, or where the
    model axis does not divide ff (a stand-in mesh of model size 3 against
    ff 128); on a (1, 1) mesh it engages."""
    m = worker.moe_module(worker.moe_inputs())
    x = torch.tensor(worker.moe_inputs()["x"])
    kw = dict(top_k=2, capacity_factor=0.0, act="silu")
    assert moe_apply_shardmap(m, x, **kw) is None
    with D.use_mesh(init_device_mesh("cpu", (1,), mesh_dim_names=("data",))):
        assert moe_apply_shardmap(m, x, **kw) is None
    three = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  mesh=np.empty((1, 3)))
    with D.use_mesh(three):
        assert moe_apply_shardmap(m, x, **kw) is None
    with D.use_mesh(init_device_mesh("cpu", (1, 1),
                                     mesh_dim_names=("data", "model"))):
        y, _ = moe_apply_shardmap(m, x, **kw)
        assert y.shape == x.shape
