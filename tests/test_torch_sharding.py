"""The port's sharding rules (``repro_torch.dist``) against the reference's
(``repro.dist``), and ``param_specs`` on the meta device.

The rules are pure shape arithmetic, so they are held to the reference
entry for entry on its lightweight stand-in meshes (an object with
``axis_names`` and ``devices.shape``, as tests/test_infra.py makes them)
for every leaf of the ten full configs: the production meshes (16, 16) and
(2, 16, 16), and a small (4, 2).  The port keeps one module per layer
where the reference stacks each pattern slot over its repeats; a
per-layer leaf's spec is the reference's spec of the stacked leaf with the
stack entry removed, and the leaves where the reference puts an axis on
the stack dimension (replicated over that axis in the port) are listed by
``dist.sharding.stack_replicated``.  Spec to placements and ``constrain``
run on a one-rank gloo group made for this module.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import configs as jconfigs
from repro.dist import constraints as jconstraints
from repro.dist import sharding as jsharding
from repro.models import init_cache as j_init_cache
from repro.models import param_specs as j_param_specs
from repro_torch import configs
from repro_torch.dist import constraints, sharding
from repro_torch.kernels.config import resolve_device
from repro_torch.models import init_cache, init_params, param_specs

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
PRODUCTION = ("16x16", "2x16x16")


def fake_mesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


_REF_SPECS: dict = {}


def ref_specs(arch):
    """The reference's ``param_specs`` of the full config, flattened:
    {(slot or None, port-style name): ShapeDtypeStruct}."""
    if arch not in _REF_SPECS:
        specs = j_param_specs(jconfigs.get_config(arch), dtype=jnp.bfloat16)
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]:
            keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
            if keys[0] == "blocks":
                out[(keys[1], ".".join(map(str, keys[2:])))] = (path, leaf)
            else:
                out[(None, ".".join(map(str, keys)))] = (path, leaf)
        _REF_SPECS[arch] = out
    return _REF_SPECS[arch]


def ref_key(name, cfg):
    """The reference leaf of the port's parameter ``name``."""
    if name.startswith("blocks."):
        _, layer, rest = name.split(".", 2)
        return int(layer) % len(cfg.block_pattern), rest
    return None, name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_partition_spec_matches_the_reference(arch, mesh_name):
    """Every stacked leaf of the reference's param_specs: the port's rule
    gives the reference's spec, entry for entry."""
    mesh = fake_mesh(mesh_name)
    for path, leaf in ref_specs(arch).values():
        want = tuple(jsharding.param_partition_spec(path, leaf, mesh))
        assert sharding.param_partition_spec(path, leaf, mesh) == want, \
            (arch, jax.tree_util.keystr(path), leaf.shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_per_layer_specs_drop_the_stack_entry(arch, mesh_name):
    """``params_shardings`` over the port's per-layer model: a block leaf
    gets the reference's stacked spec without its stack entry, a top-level
    leaf the reference's spec; ``stack_replicated`` names the stack
    entry."""
    mesh = fake_mesh(mesh_name)
    cfg = configs.get_config(arch)
    model = param_specs(cfg)
    shardings = sharding.params_shardings(model, mesh)
    ref = ref_specs(arch)
    assert len(shardings) == cfg.pattern_repeats * sum(
        1 for slot, _ in ref if slot is not None) + sum(
        1 for slot, _ in ref if slot is None)
    for name, p in model.named_parameters():
        slot, rest = ref_key(name, cfg)
        path, leaf = ref[(slot, rest)]
        want = tuple(jsharding.param_partition_spec(path, leaf, mesh))
        got = shardings[name].spec
        if slot is None:
            assert got == want, name
            assert sharding.stack_replicated(name, p, mesh, cfg) is None
        else:
            assert got == want[1:], (name, got, want)
            assert sharding.stack_replicated(name, p, mesh, cfg) == want[0]


#: the leaves the reference shards over its stack dimension on the two
#: production meshes, by arch (ROADMAP §C): (slot, leaf) -> axis
STACK_REPLICATED = {
    "olmoe-1b-7b": {(0, "ln1.scale"): "data", (0, "ln2.scale"): "data"},
    "qwen2-vl-72b": {(0, k): "data" for k in ("bq", "bk", "bv", "ln1.scale",
                                              "ln2.scale")},
    "musicgen-medium": {(0, k): "data" for k in ("ln1.scale", "ln1.bias",
                                                 "ln2.scale", "ln2.bias")},
}


@pytest.mark.parametrize("mesh_name", PRODUCTION)
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_stack_replicated_leaves(arch, mesh_name):
    """The list of stack-replicated leaves, with the bytes per device each
    adds, is the reference's stack entries, and it is the pinned list
    (``STACK_REPLICATED``; e.g. olmoe-1b-7b's (16, 2048) norms, R = 16)."""
    mesh = fake_mesh(mesh_name)
    cfg = configs.get_config(arch)
    report = sharding.stack_replicated_report(param_specs(cfg), mesh)
    want = {}
    sizes = dict(zip(*reversed(MESHES[mesh_name])))
    for (slot, rest), (path, leaf) in ref_specs(arch).items():
        spec = tuple(jsharding.param_partition_spec(path, leaf, mesh))
        if slot is not None and spec[0] is not None:
            rest_axes = [a for e in spec[1:] if e
                         for a in ((e,) if isinstance(e, str) else e)]
            per_dev = leaf.size * leaf.dtype.itemsize / np.prod(
                [sizes[a] for a in rest_axes] or [1])
            want[(slot, rest)] = (spec[0], per_dev * (1 - 1 / sizes[
                spec[0]]))
    got = {(r["slot"], r["leaf"]): (r["axis"], r["bytes_added"])
           for r in report}
    assert got == want
    assert {k: v[0] for k, v in got.items()} == STACK_REPLICATED.get(arch,
                                                                     {})


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 4, 8, 256])
def test_batch_and_cache_specs_match_the_reference(batch, mesh_name):
    """``batch_partition_spec`` equals the reference's; the per-layer
    cache's ``cache_partition_spec`` equals the reference's stacked spec
    without its stack entry, except where the stack size equals the batch
    (the reference then shards the stack; the port shards the batch)."""
    mesh = fake_mesh(mesh_name)
    for ndim in (2, 3):
        assert sharding.batch_partition_spec(mesh, batch, ndim) == tuple(
            jsharding.batch_partition_spec(mesh, batch, ndim))
    for arch in ("olmoe-1b-7b", "recurrentgemma-2b", "mamba2-130m"):
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        ref = jax.eval_shape(lambda: j_init_cache(jcfg, batch, 64))
        port = init_cache(cfg, batch, 64, device="meta")
        for layer, c in enumerate(port):
            slot = layer % len(cfg.block_pattern)
            for name, leaf in c.items():
                want = tuple(jsharding.cache_partition_spec(
                    mesh, ref[slot][name], batch))
                got = sharding.cache_partition_spec(mesh, leaf, batch)
                if want[0] is None:
                    assert got == want[1:], (arch, layer, name)
                else:
                    assert cfg.pattern_repeats == batch
                    assert got[0] == want[0] and got[1:] == (None,) * (
                        len(got) - 1)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolve_entry_matches_the_reference(mesh_name):
    mesh = fake_mesh(mesh_name)
    entries = [None, "data", "model", "pod", ("pod", "data"),
               ("data", "model")]
    for dim in (1, 2, 3, 4, 16, 32, 40, 48, 256, 512, 4096):
        for e in entries:
            assert constraints._resolve_entry(e, dim, mesh) == \
                jconstraints._resolve_entry(e, dim, mesh), (e, dim)
        assert constraints._resolve_entry(constraints.BATCH, dim, mesh) \
            == jconstraints._resolve_entry(jconstraints.BATCH, dim, mesh)


@pytest.mark.parametrize("mesh_name", PRODUCTION)
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_always_divisible(arch, mesh_name):
    """The port's counterpart of tests/test_infra.py's: no spec of the
    port's per-layer leaves names axes that do not divide their dim."""
    mesh = fake_mesh(mesh_name)
    sizes = dict(zip(*reversed(MESHES[mesh_name])))
    model = param_specs(configs.get_config(arch))
    n_sharded = 0
    for name, sh in sharding.params_shardings(model, mesh).items():
        shape = model.get_parameter(name).shape
        for d, ent in enumerate(sh.spec):
            if ent is None:
                continue
            axes = (ent,) if isinstance(ent, str) else ent
            assert shape[d] % int(np.prod([sizes[a] for a in axes])) == 0
            n_sharded += 1
    assert n_sharded > 0, "rule must shard something"


def test_big_matrices_are_fsdp_and_tp_sharded():
    """llama3-405b: every block matrix that the reference's stacked leaf
    makes big (> 2**24 elements) is sharded over both axes."""
    mesh = fake_mesh("16x16")
    cfg = configs.get_config("llama3-405b")
    model = param_specs(cfg)
    n = 0
    for name, sh in sharding.params_shardings(model, mesh).items():
        p = model.get_parameter(name)
        if name.startswith("blocks.") and p.ndim >= 2 and \
                p.numel() * cfg.pattern_repeats > 2**24:
            used = {a for e in sh.spec if e
                    for a in ((e,) if isinstance(e, str) else e)}
            assert used == {"data", "model"}, (name, sh.spec)
            n += 1
    assert n == 7 * cfg.n_layers     # wq wk wv wo gate up down


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_shapes_match_the_reference(arch):
    """``param_specs`` is the model on the meta device: every leaf's shape
    is the reference's stacked leaf's without the stack, its dtype bf16
    (or the one asked for), and nothing is allocated."""
    cfg = configs.get_config(arch)
    model = param_specs(cfg)
    ref = ref_specs(arch)
    seen = set()
    for name, p in model.named_parameters():
        key = ref_key(name, cfg)
        _, leaf = ref[key]
        seen.add(key)
        want = leaf.shape[1:] if key[0] is not None else leaf.shape
        assert tuple(p.shape) == tuple(want), name
        assert p.dtype == torch.bfloat16 and p.device.type == "meta"
    assert seen == set(ref)
    assert all(p.dtype == torch.float32 for p in
               param_specs(cfg, torch.float32).parameters())


def test_meta_is_accepted_only_where_asked():
    """``resolve_device`` takes "meta" only from the LM stack's entry
    points (``meta=True``); ``init_params`` draws weights, so it refuses
    the meta device (``param_specs`` is the meta path)."""
    assert resolve_device("meta", meta=True).type == "meta"
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(ValueError):
        init_params(configs.get_smoke_config("qwen3-14b"), 0, device="meta")


# ---------------------------------------------------------------------------
# placements and constrain on a one-rank group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    assert not dist.is_initialized(), "a process group leaked in"
    store = tmp_path_factory.mktemp("sharding") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_like(shape, names):
    """What ``placements`` reads of a ``DeviceMesh``: its dim names and
    sizes (no process group)."""
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=np.empty(shape))


def test_placements_of_a_spec():
    mesh = _mesh_like((4, 2), ("data", "model"))
    assert sharding.placements(mesh, ("model", "data")) == (Shard(1),
                                                            Shard(0))
    assert sharding.placements(mesh, (None, "model")) == (Replicate(),
                                                          Shard(1))
    assert sharding.placements(mesh, ()) == (Replicate(), Replicate())
    mesh3 = _mesh_like((2, 4, 2), ("pod", "data", "model"))
    assert sharding.placements(mesh3, (("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError):
        sharding.placements(mesh3, (("data", "pod"), None))
    # a mesh dim of size 1 replicates: one shard is the whole tensor
    assert sharding.placements(_mesh_like((1, 2), ("data", "model")),
                               ("model", "data")) == (Replicate(), Shard(0))


def test_constrain_places_the_value_and_its_gradient(group):
    """Identity without an active mesh or on a plain tensor; on a DTensor
    under ``use_mesh`` the value and, in the backward, its gradient take
    the resolved placements (replicated over axes of size 1)."""
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert constraints.constrain(x, "data", None, "model") is x
    with constraints.use_mesh(mesh):
        assert constraints.constrain(x, "data", None, "model") is x
        xd = sharding.distribute(x, sharding.NamedSharding(mesh, (None,) * 3))
        xd.requires_grad_(True)
        y = constraints.constrain(xd, constraints.BATCH, None, "model")
        assert y.placements == (Replicate(), Replicate())   # axes of size 1
        (y * 2).sum().backward()
        assert isinstance(xd.grad, DTensor)
        torch.testing.assert_close(xd.grad.full_tensor(),
                                   torch.full((2, 3, 4), 2.0))
        # the gradient passes the constraint in its placements
        xd.grad = None
        (constraints._grad_placed(xd, (Shard(0), Shard(2))) * 3).sum() \
            .backward()
        assert xd.grad.placements == (Shard(0), Shard(2))
        torch.testing.assert_close(xd.grad.full_tensor(),
                                   torch.full((2, 3, 4), 3.0))
    assert constraints._current_mesh() is None
    with pytest.raises(ValueError):
        constraints.constrain(x, None, None)
