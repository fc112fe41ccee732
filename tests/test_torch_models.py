"""The port's model stack (``repro_torch.configs``, ``repro_torch.models``)
against the reference (``repro.configs``, ``repro.models``) on the CPU.

The reference's parameters (``init_params(cfg, PRNGKey(0), float32)``) go
through ``np.asarray`` and ``params_from_reference`` into the port's
modules; inputs come from ``np.random.default_rng``.  Tolerance in f32:
max abs diff <= 1e-4 * max(1, max|ref|), unless a test states its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import mamba2 as j_mamba2
from repro.models import moe as j_moe
from repro.models import rglru as j_rglru
from repro_torch import configs
from repro_torch.models import forward, init_params, mamba2, moe, rglru
from repro_torch.models.convert import params_from_reference

B, S = 2, 16


def assert_close(got, want, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def inputs(cfg, seed: int, b: int = B, s: int = S) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if cfg.takes_embeddings:
        return (rng.normal(size=(b, s, cfg.d_model)) * 0.3).astype(
            np.float32)
    return rng.integers(0, cfg.vocab, size=(b, s))


def positions(cfg, b: int = B, s: int = S) -> np.ndarray:
    p = np.broadcast_to(np.arange(s)[None], (b, s))
    return np.ascontiguousarray(
        np.broadcast_to(p[None], (3, b, s)) if cfg.m_rope else p)


def port_model(arch: str, np_params):
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_reference(np_params, cfg))
    return model


@pytest.fixture(scope="module")
def reference():
    """Per smoke arch (built on first use): the reference's f32 params as
    numpy, and its forward's (logits, aux) on ``inputs(cfg, 1)``."""
    done = {}

    def get(arch: str):
        if arch not in done:
            cfg = jconfigs.get_smoke_config(arch)
            params = j_init_params(cfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
            logits, _, aux = j_forward(params, cfg,
                                       jnp.asarray(inputs(cfg, 1)),
                                       jnp.asarray(positions(cfg)))
            done[arch] = (jax.tree.map(np.asarray, params),
                          np.asarray(logits), float(aux))
        return done[arch]
    return get


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_fields_equal_the_reference(arch, smoke):
    get, jget = ((configs.get_smoke_config, jconfigs.get_smoke_config)
                 if smoke else (configs.get_config, jconfigs.get_config))
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))


def test_registry_equals_the_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert configs.cells() == jconfigs.cells()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_and_flops_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) == \
        jcfg.param_count(active_only=True)
    assert cfg.model_flops(8, 4096) == jcfg.model_flops(8, 4096)
    assert cfg.model_flops(8, 4096, decode=True) == \
        jcfg.model_flops(8, 4096, decode=True)


def test_qwen2_5_3b_is_the_published_width():
    cfg = configs.get_config("qwen2.5-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == (36, 2048, 16, 2, 11008, 151936)
    assert round(cfg.param_count() / 1e9, 3) == 3.397


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_converted_state_has_the_reference_parameter_count(arch,
                                                           reference):
    np_params, _, _ = reference(arch)
    cfg = configs.get_smoke_config(arch)
    state = params_from_reference(np_params, cfg)
    want = sum(a.size for a in jax.tree.leaves(np_params))
    assert sum(t.numel() for t in state.values()) == want
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    assert sum(p.numel() for p in model.parameters()) == want
    assert set(state) == set(model.state_dict())


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_forward_logits_and_aux_match_the_reference(arch, reference):
    np_params, ref_logits, ref_aux = reference(arch)
    cfg = configs.get_smoke_config(arch)
    model = port_model(arch, np_params)
    with torch.no_grad():
        logits, cache, aux = forward(model, cfg, inputs(cfg, 1),
                                     positions(cfg), device="cpu")
    assert cache is None
    assert logits.shape == (B, S, cfg.vocab)
    assert_close(logits, ref_logits)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - ref_aux) <= 1e-5 * max(1.0, abs(ref_aux))


def test_weights_are_a_function_of_the_seed():
    cfg = configs.get_smoke_config("recurrentgemma-2b")
    a = init_params(cfg, 3, device="cpu", dtype=torch.float32)
    b = init_params(cfg, 3, device="cpu", dtype=torch.float32)
    c = init_params(cfg, 4, device="cpu", dtype=torch.float32)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed, c.embed)
    assert a.blocks[2].wq.dtype == torch.float32
    bf = init_params(cfg, 3, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


def test_forward_refuses_params_of_another_config(reference):
    np_params, _, _ = reference("qwen2.5-3b")
    model = port_model("qwen2.5-3b", np_params)
    cfg = configs.get_smoke_config("qwen3-14b")
    with pytest.raises(ValueError, match="built for"):
        forward(model, cfg, inputs(cfg, 1), positions(cfg), device="cpu")


# ---------------------------------------------------------------------------
# the blocks one by one
# ---------------------------------------------------------------------------

def _block_params(arch: str, slot: int, key: str, reference):
    """Repeat 0 of pattern slot ``slot``'s ``key`` params: (reference
    pytree as jnp, the port's module of layer ``slot``)."""
    np_params, _, _ = reference(arch)
    ref = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       np_params["blocks"][slot][key])
    return ref, getattr(port_model(arch, np_params).blocks[slot], key)


@pytest.mark.parametrize("cf", [0.0, 1.25, 0.5])
def test_moe_apply_matches_the_reference(cf, reference):
    ref_p, p = _block_params("olmoe-1b-7b", 0, "moe", reference)
    x = np.random.default_rng(5).normal(size=(2, 24, 64)).astype(np.float32)
    y_ref, lg_ref = j_moe.moe_apply(ref_p, jnp.asarray(x), top_k=2,
                                    capacity_factor=cf, act="silu")
    with torch.no_grad():
        y, lg = moe.moe_apply(p, torch.tensor(x), top_k=2,
                              capacity_factor=cf, act="silu")
    assert_close(y, y_ref)
    assert_close(lg, lg_ref)
    assert abs(float(moe.load_balancing_loss(lg))
               - float(j_moe.load_balancing_loss(lg_ref))) < 1e-5
    if cf == 0.5:       # capacity 6 of 48 slots per expert: tokens dropped
        dense, _ = moe.moe_apply(p, torch.tensor(x), top_k=2,
                                 capacity_factor=0.0, act="silu")
        assert not torch.allclose(y, dense)


@pytest.mark.parametrize("case", ["prefill", "prefill_h0", "decode"])
def test_rglru_apply_matches_the_reference(case, reference):
    ref_p, p = _block_params("recurrentgemma-2b", 0, "lru", reference)
    rng = np.random.default_rng(6)
    s = 1 if case == "decode" else 37
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    h0 = cs = None
    if case != "prefill":
        h0 = rng.normal(size=(2, 64)).astype(np.float32)
        cs = rng.normal(size=(2, 3, 64)).astype(np.float32)
    y_ref, (h_ref, cs_ref) = j_rglru.rglru_apply(
        ref_p, jnp.asarray(x), None if h0 is None else jnp.asarray(h0),
        None if cs is None else jnp.asarray(cs))
    with torch.no_grad():
        y, (h, cs_new) = rglru.rglru_apply(
            p, torch.tensor(x), None if h0 is None else torch.tensor(h0),
            None if cs is None else torch.tensor(cs))
    assert_close(y, y_ref)
    assert_close(h, h_ref)
    assert_close(cs_new, cs_ref)


@pytest.mark.parametrize("t", [1, 2, 5, 64, 100])
def test_doubling_scan_in_log_form_is_the_recurrence(t):
    rng = np.random.default_rng(t)
    log_a = -rng.uniform(0.01, 1.0, (3, t, 4))
    b = rng.normal(size=(3, t, 4))
    h, want = np.zeros((3, 4)), np.zeros((3, t, 4))
    for i in range(t):
        h = np.exp(log_a[:, i]) * h + b[:, i]
        want[:, i] = h
    got = rglru.doubling_scan(torch.tensor(log_a), torch.tensor(b),
                              rglru.log_combine)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 32, 45])
def test_mamba2_apply_matches_the_reference(s, dtype, reference):
    """s = 1 is the decode step (from a carried state), 32 one whole chunk,
    45 a chunk and a padded one.  bf16: the intra-chunk tensors in bf16,
    tolerance 2e-2."""
    ref_p, p = _block_params("mamba2-130m", 0, "ssm", reference)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_p = jax.tree.map(lambda a: a.astype(jdt), ref_p)
    p = p.to(tdt)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    st = cs = None
    if s == 1:
        st = rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
        cs = rng.normal(size=(2, 3, 160)).astype(np.float32)
    kw = dict(d_model=64, ssm_state=16, head_dim=16, chunk=32)
    y_ref, (st_ref, cs_ref) = j_mamba2.mamba2_apply(
        ref_p, jnp.asarray(x).astype(jdt),
        None if st is None else jnp.asarray(st),
        None if cs is None else jnp.asarray(cs).astype(jdt), **kw)
    with torch.no_grad():
        y, (st_new, cs_new) = mamba2.mamba2_apply(
            p, torch.tensor(x).to(tdt),
            None if st is None else torch.tensor(st),
            None if cs is None else torch.tensor(cs).to(tdt), **kw)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert y.dtype == tdt and st_new.dtype == torch.float32
    assert_close(y, np.asarray(y_ref.astype(jnp.float32)), tol)
    assert_close(st_new, st_ref, tol)
    assert_close(cs_new, np.asarray(cs_ref.astype(jnp.float32)), tol)


def test_the_lm_stack_loads_neither_jax_nor_the_reference():
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.configs, repro_torch.models, "
            "repro_torch.models.convert, repro_torch.serve.step, "
            "repro_torch.examples.serve_lm; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"
