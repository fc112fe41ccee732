"""The port's ``train_step`` (``repro_torch.train.step``) on the CPU: one
step against the reference's ``repro.train.step.train_step`` from the same
weights and batch, remat on against off, microbatches against one batch,
and a tiny batch overfit.

Inputs come from ``np.random.default_rng`` (``test_torch_train.batch``);
the reference's weights cross through ``models/convert.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro.train import step as j_step
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch import configs
from repro_torch.models import init_params, transformer
from repro_torch.models.convert import params_to_reference
from repro_torch.train import step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

from test_torch_train import batch, port_model, smoke_configs

LR = 1e-3


def _grads(model, total):
    names, params = zip(*model.named_parameters())
    gs = torch.autograd.grad(total, params, allow_unused=True)
    return {n: g for n, g in zip(names, gs) if g is not None}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_train_step_matches_the_reference(arch):
    """One step (lr 1e-3, warmup 1): loss within 1e-6, grad norm within
    1e-5 (relative), and every new parameter against the reference's.

    The gate on the parameters: at step 1 Adam's update is lr * g / (|g|
    + eps), about lr * sign(g), so an entry whose gradient is near 0 can
    take the other sign in the other framework and move by up to 2 lr.
    Entries whose reference gradient is at most 1e-3 of its leaf's max
    |grad| may differ by 2 lr (+ 1e-6); every other entry must agree
    within 1e-6 * max(1, max|p|) of its leaf (there the gradients agree to
    ~1e-6 of the leaf's max, far from a sign change)."""
    jcfg, cfg = smoke_configs(arch)
    params = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    bt = batch(cfg, 1)
    jbt = jax.tree.map(jnp.asarray, bt)
    ref_p, _, ref_m = j_step.train_step(
        params, j_init_opt_state(params), jbt, cfg=jcfg,
        opt_cfg=JAdamWConfig(lr=LR, total_steps=10, warmup_steps=1))
    ref_g = jax.grad(lambda p: j_step.loss_fn(p, jcfg, jbt["inputs"],
                                              jbt["labels"])[0])(params)

    model = port_model(cfg, np_params)
    state, m = step.train_step(
        model, init_opt_state(model), bt, cfg=cfg,
        opt_cfg=AdamWConfig(lr=LR, total_steps=10, warmup_steps=1),
        device="cpu")
    assert int(state.step) == 1
    assert abs(float(m["loss"]) - float(ref_m["loss"])) <= 1e-6 * abs(
        float(ref_m["loss"]))
    assert abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) <= \
        1e-5 * float(ref_m["grad_norm"])
    assert float(m["lr"]) == pytest.approx(float(ref_m["lr"]), rel=1e-7)
    got = jax.tree.leaves(params_to_reference(model.state_dict(), cfg))
    want = jax.tree_util.tree_flatten_with_path(ref_p)[0]
    for g, (path, w), gr in zip(got, want, jax.tree.leaves(ref_g)):
        w, gr = np.asarray(w), np.abs(np.asarray(gr))
        d = np.abs(g - w)
        near0 = gr <= 1e-3 * gr.max()
        key = jax.tree_util.keystr(path)
        assert d[~near0].max(initial=0) <= 1e-6 * max(1, np.abs(w).max()), \
            key
        assert d[near0].max(initial=0) <= 2 * LR + 1e-6, key


@pytest.mark.parametrize("arch,group", [(a, 1) for a in jconfigs.ARCH_IDS]
                         + [("qwen2.5-3b", 2), ("recurrentgemma-2b", 2),
                            ("mamba2-130m", 2)])
def test_remat_on_is_bitwise_off(arch, group, monkeypatch):
    """The loss and every gradient, remat on against off, bitwise on the
    CPU; the forward checkpoints each superblock (2 repeats), and with
    ``remat_group`` 2 also the group of both."""
    _, cfg = smoke_configs(arch, group)
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    bt = batch(cfg, 2)
    inputs, labels = torch.tensor(bt["inputs"]), torch.tensor(
        bt["labels"]).long()
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)
    monkeypatch.setattr(transformer, "checkpoint", counted)
    t_on, m_on = step.loss_fn(model, cfg, inputs, labels, remat=True)
    assert calls == (["run", "one", "one"] if group == 2
                     else ["one", "one"])
    g_on = _grads(model, t_on)
    calls.clear()
    t_off, m_off = step.loss_fn(model, cfg, inputs, labels, remat=False)
    assert calls == []
    g_off = _grads(model, t_off)
    assert torch.equal(t_on, t_off)
    assert torch.equal(m_on["aux"], m_off["aux"])
    assert g_on.keys() == g_off.keys()
    for n in g_on:
        assert torch.equal(g_on[n], g_off[n]), n


def test_remat_only_under_autograd_without_a_cache(monkeypatch):
    """No checkpoint under ``no_grad`` (serving) or with a cache to
    build (prefill)."""
    _, cfg = smoke_configs("qwen2.5-3b")
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    monkeypatch.setattr(transformer, "checkpoint", None)   # would raise
    tokens = torch.tensor(batch(cfg, 3)["inputs"])
    pos = step.make_positions(cfg, *tokens.shape)
    with torch.no_grad():
        logits, _, _ = model(tokens, pos)
    assert logits.shape == (*tokens.shape, cfg.vocab)
    logits, cache, _ = model(tokens, pos, build_cache_len=20)
    assert logits.requires_grad and len(cache) == cfg.n_layers


def test_return_hidden_skips_the_head():
    _, cfg = smoke_configs("llama3-405b")
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    tokens = torch.tensor(batch(cfg, 4)["inputs"])
    pos = step.make_positions(cfg, *tokens.shape)
    with torch.no_grad():
        hidden, _, _ = model(tokens, pos, return_hidden=True)
        logits, _, _ = model(tokens, pos)
    assert hidden.shape == (*tokens.shape, cfg.d_model)
    assert torch.equal(hidden @ model.lm_head, logits)


def test_make_positions_for_m_rope():
    _, cfg = smoke_configs("qwen2-vl-72b")
    p = step.make_positions(cfg, 2, 5)
    assert p.shape == (3, 2, 5) and torch.equal(p[2, 1], torch.arange(5))
    _, cfg = smoke_configs("qwen3-14b")
    assert step.make_positions(cfg, 2, 5).shape == (2, 5)


def test_microbatches_4_match_1():
    """The reference's own rule (tests/test_models.py): the same loss
    (rtol 2e-5) and new parameters within 2e-5; the microbatch path sums
    f32 gradients and reports aux 0, as the reference's scan does."""
    _, cfg = smoke_configs("qwen3-14b")
    bt = batch(cfg, 5, b=4)
    ocfg = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    m1, m4 = (init_params(cfg, 0, device="cpu", dtype=torch.float32)
              for _ in range(2))
    _, r1 = step.train_step(m1, init_opt_state(m1), bt, cfg=cfg,
                            opt_cfg=ocfg, device="cpu")
    s4, r4 = step.train_step(m4, init_opt_state(m4), bt, cfg=cfg,
                             opt_cfg=ocfg, microbatches=4, device="cpu")
    assert float(r4["loss"]) == pytest.approx(float(r1["loss"]), rel=2e-5)
    assert float(r4["aux"]) == 0.0
    for (n, a), b in zip(m1.named_parameters(), m4.parameters()):
        assert float((a - b).detach().abs().max()) < 2e-5, n
    assert all(t.dtype == torch.float32 for t in s4.m.values())


def test_microbatches_sum_bf16_grads_in_f32(monkeypatch):
    """bf16 parameters: the summed gradients handed to AdamW are f32."""
    _, cfg = smoke_configs("stablelm-12b")
    model = init_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    seen = {}

    def spy(cfg_, model_, grads, state):
        seen.update(grads)
        return state, {}
    monkeypatch.setattr(step, "adamw_update", spy)
    step.train_step(model, init_opt_state(model), batch(cfg, 6, b=4),
                    cfg=cfg, opt_cfg=AdamWConfig(), microbatches=2,
                    device="cpu")
    assert seen and all(g.dtype == torch.float32 for g in seen.values())


def test_train_step_updates_in_place_and_refuses_another_device():
    _, cfg = smoke_configs("mixtral-8x22b")
    model = init_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    state, m = step.train_step(model, init_opt_state(model), batch(cfg, 7),
                               cfg=cfg, opt_cfg=AdamWConfig(lr=1e-2),
                               device="cpu")
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and p.data_ptr() == ptrs[n]
        assert p.grad is None
    assert not torch.equal(before["embed"], model.embed)
    assert all(v.dtype == torch.float32 for v in state.v.values())
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    with pytest.raises((RuntimeError, ValueError)):
        step.train_step(model, state, batch(cfg, 7), cfg=cfg,
                        opt_cfg=AdamWConfig())          # default: cuda


def test_overfit_tiny_batch():
    """The stack can learn (the reference's tests/test_models.py rule): the
    loss drops below 0.7 x the first loss in 30 steps on one batch."""
    cfg = configs.get_smoke_config("qwen2.5-3b")
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    state = init_opt_state(model)
    ocfg = AdamWConfig(lr=5e-3, total_steps=30, warmup_steps=2)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 16))
    bt = {"inputs": tokens, "labels": tokens}
    losses = []
    for _ in range(30):
        state, m = step.train_step(model, state, bt, cfg=cfg, opt_cfg=ocfg,
                                   device="cpu")
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.7 * losses[0], losses[::6]
