"""The port's training path (``repro_torch.models.flash_vjp``'s backward,
``repro_torch.train``) against the reference's (``repro.models.flash_vjp``,
``repro.train``) on the CPU.

The reference's parameters (``init_params(cfg, PRNGKey(0), float32)``) go
through ``np.asarray`` and ``params_from_reference`` into the port's
modules, and the port's gradients back through ``params_to_reference``;
inputs come from ``np.random.default_rng``.  Tolerance in f32: max abs
diff <= 1e-4 * max(1, max|ref|) per leaf, unless a test states its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import flash_vjp as j_flash_vjp
from repro.models import init_params as j_init_params
from repro.models import layers as jl
from repro.train import step as j_step
from repro_torch import configs
from repro_torch.models import flash_vjp, init_params, layers
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.train import step

B, S = 2, 16


def assert_close(got, want, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def assert_trees_close(got: dict, want: dict, tol=1e-4, prefix=""):
    """Leaf for leaf over the reference's tree (``want``)."""
    assert set(got) == set(want), prefix
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_trees_close(g, w, tol, f"{prefix}{k}.")
        elif isinstance(w, tuple):
            for i, (gi, wi) in enumerate(zip(g, w)):
                assert_trees_close(gi, wi, tol, f"{prefix}{k}.{i}.")
        else:
            try:
                assert_close(g, w, tol)
            except AssertionError as e:
                raise AssertionError(f"leaf {prefix}{k}: {e}") from None


def batch(cfg, seed: int, b: int = B, s: int = S) -> dict:
    """Seeded inputs (tokens, or embeddings for a stub frontend) and
    labels as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.takes_embeddings:
        inputs = (rng.normal(size=(b, s, cfg.d_model)) * 0.3).astype(
            np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def port_model(cfg, np_params):
    """The port's f32 model of ``cfg`` with the reference's weights."""
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_reference(np_params, cfg))
    return model


def smoke_configs(arch: str, remat_group: int = 1):
    """(reference config, port config) of ``arch``'s smoke config, with
    ``remat_group`` replaced."""
    return (dataclasses.replace(jconfigs.get_smoke_config(arch),
                                remat_group=remat_group),
            dataclasses.replace(configs.get_smoke_config(arch),
                                remat_group=remat_group))


@pytest.fixture(scope="module")
def reference():
    """Per smoke arch and remat group (built on first use): the
    reference's f32 params as numpy, its loss metrics and its gradients
    (numpy tree) of ``loss_fn`` on ``batch(cfg, 1)``."""
    done = {}

    def get(arch: str, remat_group: int = 1):
        if (arch, remat_group) not in done:
            cfg, _ = smoke_configs(arch, remat_group)
            params = j_init_params(cfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
            bt = jax.tree.map(jnp.asarray, batch(cfg, 1))
            grads, metrics = jax.grad(
                lambda p: j_step.loss_fn(p, cfg, bt["inputs"],
                                         bt["labels"]), has_aux=True)(params)
            done[arch, remat_group] = (
                jax.tree.map(np.asarray, params),
                {k: float(v) for k, v in metrics.items()},
                jax.tree.map(np.asarray, grads))
        return done[arch, remat_group]
    return get


def qkv(seed, b, s, kvh, g, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, kvh, g, hd)).astype(np.float32),
            rng.normal(size=(b, s, kvh, hd)).astype(np.float32),
            rng.normal(size=(b, s, kvh, hd)).astype(np.float32),
            rng.normal(size=(b, s, kvh, g, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

# the windows and chunk sizes of the reference's own flash tests
# (tests/test_attention.py::test_flash_forward_and_grads_match_naive)
FLASH_CASES = [(w, qc, kc) for w in (None, 24)
               for qc, kc in ((32, 16), (16, 64), (128, 128))]


@pytest.mark.parametrize("window,qc,kc", FLASH_CASES)
def test_flash_core_lse_and_grads_match_the_reference(window, qc, kc):
    """``flash_core``'s (dq, dk, dv) under a seeded cotangent against
    ``jax.vjp`` of the reference's, and ``_flash_fwd_impl``'s (o, lse),
    at S = 128 (whole chunks: the core takes them padded)."""
    q, k, v, do = qkv(0, 2, 128, 4, 2, 16)
    pos = np.arange(128)
    o_ref, lse_ref = j_flash_vjp._flash_fwd_impl(
        *map(jnp.asarray, (q, k, v, pos, pos)), window, qc, kc)
    o, lse = flash_vjp._flash_fwd_impl(
        *map(torch.tensor, (q, k, v, pos, pos)), window, qc, kc)
    assert lse.dtype == torch.float32 and lse.shape == (2, 128, 4, 2)
    assert_close(o, o_ref, 1e-5)
    assert_close(lse, lse_ref, 1e-5)

    _, vjp = jax.vjp(lambda a, b_, c: j_flash_vjp.flash_core(
        a, b_, c, jnp.asarray(pos), jnp.asarray(pos), window, qc, kc),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_vjp.flash_core(tq, tk, tv, torch.tensor(pos),
                               torch.tensor(pos), window, qc, kc)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_close(g, w, 1e-5)


def test_flash_core_backward_in_bf16_matches_the_reference():
    """bf16 inputs: the gradients come back in bf16 (f32 inside)."""
    q, k, v, do = qkv(1, 2, 64, 2, 4, 16)
    pos = np.arange(64)
    cast = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b_, c: j_flash_vjp.flash_core(
        a, b_, c, jnp.asarray(pos), jnp.asarray(pos), None, 16, 32),
        *map(cast, (q, k, v)))
    want = vjp(cast(do))
    tq, tk, tv = (torch.tensor(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    out = flash_vjp.flash_core(tq, tk, tv, torch.tensor(pos),
                               torch.tensor(pos), None, 16, 32)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert_close(g, w, 2e-2)


@pytest.mark.parametrize("window,qc,kc", FLASH_CASES + [(7, 32, 16)])
def test_flash_attention_grads_match_the_reference(window, qc, kc):
    """Through ``flash_attention``: the full path's Function and the
    windowed KV band (plain ops, autograd), padded chunks included
    (S = 90)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 90, 8, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 90, 4, 16)).astype(np.float32)
            for _ in range(2))
    w = rng.normal(size=(2, 90, 8, 16)).astype(np.float32)
    pos = np.arange(90)

    def ref(a, b_, c):
        return jnp.sum(jl.flash_attention(
            a, b_, c, jnp.asarray(pos), jnp.asarray(pos), window=window,
            q_chunk=qc, kv_chunk=kc) * w)
    want = jax.grad(ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = layers.flash_attention(tq, tk, tv, torch.tensor(pos),
                                 torch.tensor(pos), window=window,
                                 q_chunk=qc, kv_chunk=kc)
    got = torch.autograd.grad(torch.sum(out * torch.tensor(w)),
                              (tq, tk, tv))
    for g, r in zip(got, want):
        assert_close(g, r, 1e-5)


def test_serving_keeps_no_graph():
    """Under ``no_grad`` the Function saves nothing reachable: the output
    carries no graph."""
    q, k, v, _ = qkv(3, 1, 32, 2, 2, 8)
    tq = torch.tensor(q, requires_grad=True)
    with torch.no_grad():
        out = flash_vjp.flash_core(tq, torch.tensor(k), torch.tensor(v),
                                   torch.arange(32), torch.arange(32), None,
                                   16, 16)
    assert out.grad_fn is None and not out.requires_grad


# ---------------------------------------------------------------------------
# the loss and its gradients, all ten smoke configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,group", [(a, 1) for a in jconfigs.ARCH_IDS]
                         + [("qwen2.5-3b", 2), ("recurrentgemma-2b", 2)])
def test_loss_and_grads_match_the_reference(arch, group, reference):
    """``loss_fn``'s loss, MoE aux and every leaf's gradient against
    ``jax.grad`` of the reference's (remat on in both; ``group`` 2 is the
    nested group checkpoint over the two repeats)."""
    np_params, ref_metrics, ref_grads = reference(arch, group)
    _, cfg = smoke_configs(arch, group)
    model = port_model(cfg, np_params)
    bt = batch(cfg, 1)
    total, metrics = step.loss_fn(model, cfg, torch.tensor(bt["inputs"]),
                                  torch.tensor(bt["labels"]).long())
    assert abs(float(metrics["loss"]) - ref_metrics["loss"]) <= 1e-5 * max(
        1.0, abs(ref_metrics["loss"]))
    assert abs(float(metrics["aux"]) - ref_metrics["aux"]) <= 1e-5 * max(
        1.0, abs(ref_metrics["aux"]))
    if cfg.n_experts:
        assert float(metrics["aux"]) > 0
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, grads)}
    assert_trees_close(params_to_reference(grads, cfg), ref_grads)
