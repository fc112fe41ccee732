"""Rank program of the LM stack's mesh tests (``test_torch_lm_mesh.py``).

Spawned once per rank by ``torch.multiprocessing``; imports only
``repro_torch`` and numpy (a spawned rank re-imports the module of its
target, so this one must not load JAX).  Every rank joins a gloo group
through a file store, runs the same program on its shards (SPMD) and
writes what it got, as whole tensors, to ``rank<r>.npz``; the test process
compares the ranks with the port's unsharded results and with the
reference's.  Inputs come from ``inputs.npz`` in the run's directory,
which the test process writes (the reference's parameters among them).

Parts: ``"lm"`` (world 4): the explicit-dispatch MoE on the meshes (2, 2)
and (1, 4), then one sharded ``train_step`` on (2, 2) per arch of
``TRAIN_ARCHS``; ``"reshard"`` (world 2): a checkpoint saved from a (2,)
mesh and loaded onto a (1, 2) one.
"""
import os
import time

import numpy as np

#: the MoE parity inputs: a mixtral-smoke MoE block (d 64, ff 128, 4
#: experts, top-2) on a (4, 16, 64) batch
MOE = dict(d=64, ff=128, experts=4, top_k=2, batch=(4, 16))
MOE_MESHES = ((2, 2), (1, 4))
#: (mesh, capacity factor): 0 is exact mode, the configs' 1.25 drops
MOE_CASES = tuple((m, cf) for m in MOE_MESHES for cf in (0.0, 1.25))
TRAIN_ARCHS = ("qwen3-14b", "mixtral-8x22b", "mamba2-130m")
TRAIN_BATCH = (4, 16)
LR = 1e-3


def moe_inputs(seed: int = 0) -> dict:
    """The MoE block's weights, x and the cotangents of y and the logits,
    from ``default_rng(seed)`` (f32)."""
    rng = np.random.default_rng(seed)
    d, ff, e = MOE["d"], MOE["ff"], MOE["experts"]
    t = MOE["batch"][0] * MOE["batch"][1]

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"router": f32(d, e, scale=0.5), "gate": f32(e, d, ff, scale=0.1),
            "up": f32(e, d, ff, scale=0.1), "down": f32(e, ff, d, scale=0.1),
            "x": f32(*MOE["batch"], d), "gy": f32(*MOE["batch"], d),
            "glogits": f32(t, e)}


def moe_module(inputs: dict):
    """The port's ``MoE`` module holding ``inputs``' weights."""
    import torch

    from repro_torch.models.moe import MoE
    gen = torch.Generator().manual_seed(0)
    m = MoE(gen, MOE["d"], MOE["ff"], MOE["experts"], "silu", torch.float32)
    with torch.no_grad():
        m.router.copy_(torch.tensor(inputs["router"]))
        for name in ("gate", "up", "down"):
            getattr(m.experts, name).copy_(torch.tensor(inputs[name]))
    return m


def moe_grads(m, x, y, logits, inputs) -> dict:
    """y, the logits and the gradients of <y, gy> + <logits, glogits> with
    respect to x and every weight, as whole numpy arrays."""
    import torch
    from torch.distributed.tensor import DTensor

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()
    gy, gl = torch.tensor(inputs["gy"]), torch.tensor(inputs["glogits"])
    total = (y * gy).sum() + (logits * gl).sum()
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(total, (x,) + params)
    out = {"y": whole(y), "logits": whole(logits), "grad.x": whole(grads[0])}
    out.update({f"grad.{n}": whole(g) for n, g in zip(names, grads[1:])})
    return out


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
    # loopback only, and one thread a rank: the ranks share the host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import warnings

    import torch
    import torch.distributed as dist

    # DTensor warns of sequential all-reduces over a 2-D mesh; expected
    warnings.filterwarnings("ignore", module="torch.distributed")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        if part == "lm":
            got = _lm(dict(np.load(os.path.join(out_dir, "inputs.npz"))))
        else:
            got = _reshard(out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _lm(inputs: dict) -> dict:
    import torch

    from repro_torch import dist as D
    from repro_torch.models import moe_shardmap
    from repro_torch.models.moe import moe_apply
    out = {}
    mi = moe_inputs()
    meshes = {shape: _mesh(shape) for shape in MOE_MESHES}
    for shape, cf in MOE_CASES:
        mesh = meshes[shape]
        tag = f"moe.{shape[0]}x{shape[1]}.cf{cf}"
        kw = dict(top_k=MOE["top_k"], capacity_factor=cf, act="silu")
        m = moe_module(mi)
        x = torch.tensor(mi["x"], requires_grad=True)
        out.update({f"{tag}.plain.{k}": v for k, v in moe_grads(
            m, x, *moe_apply(m, x, **kw), mi).items()})
        D.distribute_params(m, {n: D.NamedSharding(mesh, D.param_partition_spec(
            n, p, mesh)) for n, p in m.named_parameters()})
        xd = D.distribute(torch.tensor(mi["x"]), D.NamedSharding(
            mesh, D.batch_partition_spec(mesh, x.shape[0], 3)))
        xd.requires_grad_(True)
        moe_shardmap.reset_engaged_count()
        with D.use_mesh(mesh):
            res = moe_shardmap.moe_apply_shardmap(m, xd, **kw)
            out[f"{tag}.engaged"] = np.array(moe_shardmap.engaged_count())
            out.update({f"{tag}.sharded.{k}": v for k, v in moe_grads(
                m, xd, *res, mi).items()})
    out.update(_train(inputs, meshes[(2, 2)]))
    return out


def _train(inputs: dict, mesh) -> dict:
    """One ``train_step`` per arch from the reference's weights
    (``inputs``): unsharded, then with DTensor parameters and batch under
    ``use_mesh``; the new parameters of both, their metrics, and the
    explicit-dispatch MoE's engagements."""
    import torch

    from repro_torch import configs
    from repro_torch import dist as D
    from repro_torch.models import init_params, moe_shardmap
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import train_step
    out = {}
    ocfg = AdamWConfig(lr=LR, total_steps=10, warmup_steps=1)
    for arch in TRAIN_ARCHS:
        cfg = configs.get_smoke_config(arch)
        state = {k[len(arch) + 7:]: torch.tensor(v) for k, v in inputs.items()
                 if k.startswith(f"{arch}.param.")}
        batch = {k: torch.tensor(inputs[f"{arch}.{k}"])
                 for k in ("inputs", "labels")}
        for how in ("plain", "sharded"):
            model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
            model.load_state_dict(state)
            bt = batch
            moe_shardmap.reset_engaged_count()
            if how == "sharded":
                D.distribute_params(model, D.params_shardings(model, mesh))
                bt = {k: D.distribute(v, D.NamedSharding(
                          mesh, D.batch_partition_spec(mesh, v.shape[0],
                                                       v.ndim)))
                      for k, v in batch.items()}
                with D.use_mesh(mesh):
                    _, m = train_step(model, init_opt_state(model), bt,
                                      cfg=cfg, opt_cfg=ocfg, device="cpu")
            else:
                _, m = train_step(model, init_opt_state(model), bt, cfg=cfg,
                                  opt_cfg=ocfg, device="cpu")
            tag = f"{arch}.{how}"
            out[f"{tag}.engaged"] = np.array(moe_shardmap.engaged_count())
            out.update({f"{tag}.{k}": np.asarray(float(v))
                        for k, v in m.items()})
            for name, p in model.named_parameters():
                p = p.full_tensor() if how == "sharded" else p
                out[f"{tag}.param.{name}"] = p.detach().numpy()
    return out


def _reshard(out_dir: str) -> dict:
    """A tree saved from the (2,) ("data",) mesh, each leaf sharded on its
    first dim, loaded onto the (1, 2) ("data", "model") mesh sharded on its
    last dim: the whole tensors and this rank's shards."""
    import torch

    from repro_torch import dist as D
    from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
    tree = {"w": torch.arange(64.0).reshape(8, 8),
            "opt": (torch.linspace(-1, 1, 32).reshape(4, 8)
                    .to(torch.bfloat16), torch.arange(16, dtype=torch.int32)
                    .reshape(2, 8))}
    m1, m2 = _mesh((2,), ("data",)), _mesh((1, 2))

    def place(mesh, spec):
        return lambda t: D.distribute(t, D.NamedSharding(mesh, spec(t)))
    first = place(m1, lambda t: ("data",) + (None,) * (t.ndim - 1))
    t1 = {"w": first(tree["w"]), "opt": tuple(map(first, tree["opt"]))}
    f = save_checkpoint(os.path.join(out_dir, "ckpt"), t1, step=3)
    last = (lambda t: D.NamedSharding(m2, (None,) * (t.ndim - 1)
                                      + ("model",)))
    sh = {"w": last(tree["w"]), "opt": tuple(map(last, tree["opt"]))}
    t2, step = load_checkpoint(f, tree, device="cpu", shardings=sh)
    out = {"step": np.array(step)}
    for key, want, got in (("w", tree["w"], t2["w"]),
                           ("opt0", tree["opt"][0], t2["opt"][0]),
                           ("opt1", tree["opt"][1], t2["opt"][1])):
        out[f"{key}.whole"] = got.full_tensor().view(torch.int16).numpy() \
            if got.dtype == torch.bfloat16 else got.full_tensor().numpy()
        out[f"{key}.local"] = got.to_local().float().numpy()
        out[f"{key}.placements"] = np.array(str(got.placements))
        out[f"{key}.want"] = want.view(torch.int16).numpy() \
            if want.dtype == torch.bfloat16 else want.numpy()
    return out
