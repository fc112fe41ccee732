"""The port's LM serving path (``repro_torch.serve.step`` over
``repro_torch.models``) against the reference's (``repro.serve.step``) on
the CPU, and the reference's own serving invariants (``tests/
test_serve.py``) on the port.

The reference's f32 parameters (``init_params(cfg, PRNGKey(0))``) go into
the port through ``params_from_reference``; prompts come from
``np.random.default_rng``; caches cross with ``cache_from_reference`` /
``cache_to_reference``.  Tolerance: max abs diff <= 1e-4 * max(1, max|ref|)
in f32; 1e-2 where a bf16 cache is read or compared (bf16 keeps 8 bits);
the invariants keep the reference test's rtol = atol = 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro.serve import step as j_step
from repro_torch import configs
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models.convert import (cache_from_reference,
                                        cache_to_reference,
                                        params_from_reference)
from repro_torch.serve.step import greedy_generate, prefill, serve_step

B = 2
S, EXTRA = 20, 6            # prompt (longer than the smoke windows of 16)
STEPS = 3                   # serve_step calls held against the reference
TOKEN_ARCHS = [a for a in jconfigs.ARCH_IDS
               if not jconfigs.get_smoke_config(a).takes_embeddings]
# one per cache kind: full attn, MoE + SWA ring, RG-LRU + local ring, SSM
INVARIANT_ARCHS = ("qwen3-14b", "mixtral-8x22b", "recurrentgemma-2b",
                   "mamba2-130m")


def assert_close(got, want, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def tokens(cfg, seed: int, b: int, s: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if cfg.takes_embeddings:
        return (rng.normal(size=(b, s, cfg.d_model)) * 0.3).astype(
            np.float32)
    return rng.integers(0, cfg.vocab, size=(b, s))


def model_of(cfg, np_params):
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_reference(np_params, cfg))
    return model


@pytest.fixture(scope="module")
def ref():
    """Per smoke arch (built on first use): the reference's params, its
    prefill of ``tokens(cfg, 1, B, S + EXTRA)[:, :S]`` at both cache
    dtypes, its serve_step logits for the next ``STEPS`` tokens from the
    f32 cache, and its greedy tokens (token archs)."""
    done = {}

    def get(arch: str):
        if arch in done:
            return done[arch]
        cfg = jconfigs.get_smoke_config(arch)
        params = j_init_params(cfg, jax.random.PRNGKey(0),
                               dtype=jnp.float32)
        toks = jnp.asarray(tokens(cfg, 1, B, S + EXTRA))
        out = {"params": jax.tree.map(np.asarray, params), "toks": toks}
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            cache, logits = j_step.prefill(params, cfg, toks[:, :S],
                                           max_len=S + EXTRA,
                                           cache_dtype=dt)
            out[name] = (jax.tree.map(np.asarray, cache), np.asarray(logits))
        cache = out["f32"][0]
        steps = []
        for t in range(S, S + STEPS):
            lg, cache = j_step.serve_step(params, cache, toks[:, t:t + 1],
                                          jnp.asarray(t), cfg=cfg)
            steps.append(np.asarray(lg))
        out["steps"] = steps
        out["step_cache"] = jax.tree.map(np.asarray, cache)
        if not cfg.takes_embeddings:
            out["greedy"] = np.asarray(j_step.greedy_generate(
                params, cfg, toks[:, :8], n_new=5, max_len=16,
                cache_dtype=jnp.float32))
        done[arch] = out
        return out
    return get


def assert_cache_close(got: tuple, want: tuple, tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            if name == "pos":
                np.testing.assert_array_equal(g[name], w[name])
            else:
                assert_close(g[name], w[name], tol)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_prefill_logits_and_cache_match_the_reference(arch, ref):
    r = ref(arch)
    cfg = configs.get_smoke_config(arch)
    model = model_of(cfg, r["params"])
    cache, logits = prefill(model, cfg, np.array(r["toks"])[:, :S],
                            max_len=S + EXTRA, cache_dtype=torch.float32,
                            device="cpu")
    ref_cache, ref_logits = r["f32"]
    assert logits.shape == (B, S, cfg.vocab)
    assert_close(logits, ref_logits)
    assert len(cache) == cfg.n_layers
    assert_cache_close(cache_to_reference(cache, cfg), ref_cache)


_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_prefill_bf16_cache_follows_the_reference_cast_rule(arch, ref):
    """Attention k / v, both conv states and Mamba2's SSM state become
    bf16; RG-LRU's h stays f32 and pos int32, leaf for leaf as the
    reference's; one serve_step from that cache matches too."""
    r = ref(arch)
    cfg = configs.get_smoke_config(arch)
    model = model_of(cfg, r["params"])
    cache, logits = prefill(model, cfg, np.array(r["toks"])[:, :S],
                            max_len=S + EXTRA, device="cpu")
    ref_cache, ref_logits = r["bf16"]
    assert_close(logits, ref_logits)
    for layer, c in enumerate(cache):
        want = ref_cache[layer % len(cfg.block_pattern)]
        assert {k: v.dtype for k, v in c.items()} == \
            {k: _DTYPE[v.dtype.name] for k, v in want.items()}, layer
    assert_cache_close(cache_to_reference(cache, cfg), ref_cache, 1e-2)

    params = jax.tree.map(jnp.asarray, r["params"])
    tok = r["toks"][:, S:S + 1]
    lg_ref, _ = j_step.serve_step(params, jax.tree.map(jnp.asarray,
                                                       ref_cache),
                                  tok, jnp.asarray(S), cfg=jconfigs
                                  .get_smoke_config(arch))
    lg, _ = serve_step(model, cache_from_reference(ref_cache, cfg),
                       np.array(tok), S, cfg=cfg, device="cpu")
    assert_close(lg, lg_ref, 1e-2)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-2b"])
def test_windowed_prefill_longer_than_the_window_keeps_a_ring(arch, ref):
    """A 40-token prompt over a window of 16: each attention cache keeps
    positions 24..39, position p in slot p % 16, as the reference's."""
    r = ref(arch)
    cfg = configs.get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    toks = tokens(cfg, 2, B, 40)
    ref_cache, ref_logits = j_step.prefill(
        jax.tree.map(jnp.asarray, r["params"]), jcfg, jnp.asarray(toks),
        max_len=64, cache_dtype=jnp.float32)
    cache, logits = prefill(model_of(cfg, r["params"]), cfg, toks,
                            max_len=64, cache_dtype=torch.float32,
                            device="cpu")
    assert_close(logits, ref_logits)
    assert_cache_close(cache_to_reference(cache, cfg),
                       jax.tree.map(np.asarray, ref_cache))
    slots = np.arange(cfg.attn_window)
    for c in cache:
        if "pos" in c:
            assert c["k"].shape[1] == cfg.attn_window
            want = np.where(slots >= 8, slots + 16, slots + 32)
            np.testing.assert_array_equal(c["pos"].numpy(),
                                          np.broadcast_to(want, (B, 16)))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_serve_step_matches_the_reference_from_the_same_cache(arch, ref):
    r = ref(arch)
    cfg = configs.get_smoke_config(arch)
    model = model_of(cfg, r["params"])
    cache = cache_from_reference(r["f32"][0], cfg)
    toks = np.array(r["toks"])
    for i, t in enumerate(range(S, S + STEPS)):
        lg, cache = serve_step(model, cache, toks[:, t:t + 1], t, cfg=cfg,
                               device="cpu")
        assert lg.shape == (B, cfg.vocab)
        assert_close(lg, r["steps"][i])
    assert_cache_close(cache_to_reference(cache, cfg), r["step_cache"])


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_generate_tokens_equal_the_reference(arch, ref):
    r = ref(arch)
    cfg = configs.get_smoke_config(arch)
    out = greedy_generate(model_of(cfg, r["params"]), cfg,
                          np.array(r["toks"])[:, :8], 5, max_len=16,
                          cache_dtype=torch.float32, device="cpu")
    assert out.shape == (B, 5)
    np.testing.assert_array_equal(out.numpy(), r["greedy"])


# ---------------------------------------------------------------------------
# the reference's invariants, on the port
# ---------------------------------------------------------------------------

def _pos(cfg, b, s, start=0):
    p = torch.arange(start, start + s)[None].expand(b, s)
    return p[None].expand(3, b, s) if cfg.m_rope else p


def _model(arch):
    cfg = configs.get_smoke_config(arch)
    return cfg, init_params(cfg, 0, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("arch", INVARIANT_ARCHS)
def test_decode_matches_full_forward(arch):
    cfg, model = _model(arch)
    s = 20
    toks = torch.tensor(tokens(cfg, 1, B, s))
    with torch.no_grad():
        full, _, _ = forward(model, cfg, toks, _pos(cfg, B, s),
                             device="cpu")
        cache = init_cache(cfg, B, max_len=s, device="cpu",
                           dtype=torch.float32)
        outs = []
        for t in range(s):
            lg, cache, _ = forward(model, cfg, toks[:, t:t + 1],
                                   _pos(cfg, B, 1, t), cache=cache,
                                   cur_pos=t, device="cpu")
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", INVARIANT_ARCHS)
def test_prefill_matches_decode_replay(arch):
    cfg, model = _model(arch)
    s, extra = 18, 5
    toks = torch.tensor(tokens(cfg, 1, B, s + extra))
    cache, _ = prefill(model, cfg, toks[:, :s], max_len=s + extra,
                       cache_dtype=torch.float32, device="cpu")
    cache_r = init_cache(cfg, B, max_len=s + extra, device="cpu",
                         dtype=torch.float32)
    with torch.no_grad():
        for t in range(s):
            _, cache_r, _ = forward(model, cfg, toks[:, t:t + 1],
                                    _pos(cfg, B, 1, t), cache=cache_r,
                                    cur_pos=t, device="cpu")
    for t in range(s, s + extra):
        lg_a, cache = serve_step(model, cache, toks[:, t:t + 1], t, cfg=cfg,
                                 device="cpu")
        lg_b, cache_r = serve_step(model, cache_r, toks[:, t:t + 1], t,
                                   cfg=cfg, device="cpu")
        np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_ring_cache_is_window_sized():
    cfg = configs.get_smoke_config("mixtral-8x22b")      # window 16
    cache = init_cache(cfg, B, max_len=1000, device="cpu",
                       dtype=torch.float32)
    assert cache[0]["k"].shape[1] == cfg.attn_window, \
        "windowed cache must be ring-buffer sized, not context sized"
    cfg2 = configs.get_smoke_config("mamba2-130m")
    c2 = init_cache(cfg2, B, max_len=10**6, device="cpu",
                    dtype=torch.float32)
    assert sum(t.numel() for c in c2 for t in c.values()) < 10**6, \
        "SSM cache must be O(1) in context length"


def test_windowed_decode_beyond_window_consistent():
    """Decoding past the window: ring overwrite equals the full recompute
    restricted to the window."""
    cfg, model = _model("mixtral-8x22b")
    s = cfg.attn_window + 9
    toks = torch.tensor(tokens(cfg, 1, B, s))
    with torch.no_grad():
        full, _, _ = forward(model, cfg, toks, _pos(cfg, B, s),
                             device="cpu")
        cache = init_cache(cfg, B, max_len=s, device="cpu",
                           dtype=torch.float32)
        for t in range(s):
            lg, cache, _ = forward(model, cfg, toks[:, t:t + 1],
                                   _pos(cfg, B, 1, t), cache=cache,
                                   cur_pos=t, device="cpu")
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the default device is the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["init_params", "init_cache", "forward",
                                   "prefill", "serve_step",
                                   "greedy_generate"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    cfg, model = _model("qwen2.5-3b")
    toks = tokens(cfg, 1, B, 4)
    calls = {
        "init_params": lambda: init_params(cfg, 0),
        "init_cache": lambda: init_cache(cfg, B, 8),
        "forward": lambda: forward(model, cfg, toks, _pos(cfg, B, 4)),
        "prefill": lambda: prefill(model, cfg, toks, max_len=8),
        "serve_step": lambda: serve_step(
            model, init_cache(cfg, B, 8, device="cpu"), toks[:, :1], 0,
            cfg=cfg),
        "greedy_generate": lambda: greedy_generate(model, cfg, toks, 2,
                                                   max_len=8),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()

