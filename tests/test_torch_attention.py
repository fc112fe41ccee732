"""The port's layers (``repro_torch.models.layers`` and ``flash_vjp``)
against the reference's (``repro.models.layers``, ``flash_vjp``) on the
CPU, on the same numpy inputs from ``np.random.default_rng``.

Tolerance: max abs diff <= 1e-4 * max(1, max|ref|) in f32 (1e-5 for the
attention paths, which sum at most a few hundred products); 2e-2 in bf16.
Each attention path is pinned: the tests that name a path make the others
raise.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash_vjp as j_flash_vjp
from repro.models import layers as jl
from repro.models.transformer import MROPE_SECTIONS as J_MROPE
from repro_torch.models import flash_vjp, layers
from repro_torch.models.transformer import MROPE_SECTIONS


def assert_close(got, want, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def qkv(seed, b, s, h, kvh, hd, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, hd)).astype(np.float32))


def both(fn_ref, fn, arrays, dtype="float32", **kw):
    """``fn_ref`` on jnp arrays and ``fn`` on torch tensors of ``arrays``
    (floats cast to ``dtype``)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jcast(a):
        return jnp.asarray(a).astype(jdt) if a.dtype.kind == "f" \
            else jnp.asarray(a)

    def tcast(a):
        t = torch.tensor(a)
        return t.to(tdt) if t.is_floating_point() else t
    with torch.no_grad():
        return (fn_ref(*map(jcast, arrays), **kw),
                fn(*map(tcast, arrays), **kw))


@pytest.fixture
def only(monkeypatch):
    """``only(path)``: make every attention path but ``path`` raise."""
    def fail(*a, **k):
        raise AssertionError("wrong attention path")

    def pin(path):
        if path != "flash_core":
            monkeypatch.setattr(flash_vjp, "flash_core", fail)
        if path != "band":
            monkeypatch.setattr(layers, "_attend_block", fail)
    return pin


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("qc,kc", [(32, 16), (16, 64), (128, 128)])
def test_flash_attention_matches_the_reference(window, qc, kc):
    q, k, v = qkv(0, 2, 96, 8, 4, 16)
    pos = np.arange(96)
    ref, got = both(jl.flash_attention, layers.flash_attention,
                    (q, k, v, pos, pos), window=window, q_chunk=qc,
                    kv_chunk=kc)
    assert_close(got, ref)


@pytest.mark.parametrize("window", [7, 33])
def test_flash_attention_band_path_matches_the_reference(window, only):
    only("band")
    q, k, v = qkv(1, 2, 200, 4, 2, 8)
    pos = np.arange(200)
    ref, got = both(jl.flash_attention, layers.flash_attention,
                    (q, k, v, pos, pos), window=window, q_chunk=32,
                    kv_chunk=16)
    assert_close(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_ctx_parallel_path_matches_the_reference(
        window, dtype, only):
    """The reference's context-parallel prefill path (nq = 5 query chunks,
    the last one padded, through 2 kv chunks) against the port's single
    path, ``flash_core``, which the port's prefill runs."""
    only("flash_core")
    q, k, v = qkv(2, 2, 70, 6, 2, 16)
    pos = np.arange(70)
    ref, got = both(functools.partial(jl.flash_attention, ctx_parallel=True),
                    layers.flash_attention, (q, k, v, pos, pos),
                    dtype=dtype, window=window, q_chunk=16, kv_chunk=64)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, ref, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_core_path_matches_the_reference(dtype, only):
    """One query chunk takes the core; the core alone matches the
    reference's forward at several query chunks."""
    only("flash_core")
    q, k, v = qkv(3, 2, 48, 4, 4, 16)
    pos = np.arange(48)
    ref, got = both(jl.flash_attention, layers.flash_attention,
                    (q, k, v, pos, pos), dtype=dtype, q_chunk=64,
                    kv_chunk=16)
    assert_close(got, ref, 1e-5 if dtype == "float32" else 2e-2)
    q5 = q.reshape(2, 48, 4, 1, 16)
    (o_ref, _), o = both(
        j_flash_vjp._flash_fwd_impl, flash_vjp.flash_core,
        (q5, k, v, pos, pos), dtype=dtype, window=None, q_chunk=16,
        kv_chunk=16)
    assert o.dtype == getattr(torch, dtype)
    assert_close(o, o_ref, 1e-5 if dtype == "float32" else 2e-2)


def test_flash_attention_with_gqa_and_offset_queries():
    """Queries at positions 40..71 over keys 0..71 (a continued prompt);
    head h reads kv head h // G."""
    q, k, v = qkv(4, 1, 32, 8, 2, 8, skv=72)
    qpos, kpos = np.arange(40, 72), np.arange(72)
    ref, got = both(jl.flash_attention, layers.flash_attention,
                    (q, k, v, qpos, kpos), window=None, q_chunk=16,
                    kv_chunk=32)
    assert_close(got, ref)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 16])
def test_decode_attention_matches_on_a_ring_cache_with_empty_slots(window):
    """Batch row 0: a ring of 16 slots after 21 tokens (positions 16..20
    overwrote slots 0..4); row 1: 9 tokens, slots 9..15 empty (-1)."""
    b, c, h, kvh, hd = 2, 16, 4, 2, 16
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    kc = rng.normal(size=(b, c, kvh, hd)).astype(np.float32)
    vc = rng.normal(size=(b, c, kvh, hd)).astype(np.float32)
    slots = np.arange(c)
    kv_pos = np.stack([np.where(slots < 5, slots + 16, slots),
                       np.where(slots < 9, slots, -1)]).astype(np.int32)
    qpos = np.array([20, 8], np.int32)
    ref, got = both(jl.decode_attention, layers.decode_attention,
                    (q, kc, vc, qpos, kv_pos), window=window)
    assert_close(got, ref)


# ---------------------------------------------------------------------------
# RoPE, norms, MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_the_reference(dtype):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(500, 512)])
    ref, got = both(jl.apply_rope, layers.apply_rope, (x, pos), dtype=dtype,
                    theta=1e4)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, ref, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("hd", [16, 128, 160])
def test_m_rope_matches_the_reference(hd):
    """Qwen2-VL sections (16, 24, 24) over hd/2 slots: cut (hd 16), exact
    (128) and padded with the last section (160)."""
    assert MROPE_SECTIONS == J_MROPE
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, 2, hd)).astype(np.float32)
    pos = rng.integers(0, 300, size=(3, 2, 10))
    ref, got = both(jl.apply_rope, layers.apply_rope, (x, pos), theta=1e6,
                    m_rope_sections=MROPE_SECTIONS)
    assert_close(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_the_reference(dtype):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=64).astype(np.float32)
    beta = rng.normal(size=64).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    ref, got = both(jl.rmsnorm, layers.rmsnorm, (x, g), dtype=dtype,
                    eps=1e-5)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, ref, tol)
    ref, got = both(jl.layernorm, layers.layernorm, (x, g, beta),
                    dtype=dtype, eps=1e-5)
    assert_close(got, ref, tol)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_the_reference(act):
    rng = np.random.default_rng(9)
    d, ff = 32, 48
    w = {n: (rng.normal(size=(ff, d) if n == "down" else (d, ff))
             / 6).astype(np.float32) for n in ("gate", "up", "down")}
    if act == "gelu":
        del w["gate"]
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    ref = jl.mlp_apply({n: jnp.asarray(a) for n, a in w.items()},
                       jnp.asarray(x), act)
    gen = torch.Generator().manual_seed(0)
    mlp = layers.MLP(gen, d, ff, act, torch.float32)
    assert {n for n, _ in mlp.named_parameters()} == set(w)
    mlp.load_state_dict({n: torch.tensor(a) for n, a in w.items()})
    with torch.no_grad():
        got = layers.mlp_apply(mlp, torch.tensor(x), act)
    assert_close(got, ref)


def test_dense_init_draws_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    a = layers.dense_init(gen, (64, 8), torch.float32)
    b = layers.dense_init(torch.Generator().manual_seed(3), (64, 8),
                          torch.float32)
    assert torch.equal(a, b)
    assert abs(float(a.detach().std()) - 1 / 8) < 0.03
    c = layers.dense_init(gen, (64, 8), torch.bfloat16, scale=0.02)
    assert c.dtype == torch.bfloat16 and \
        float(c.detach().float().abs().max()) < 0.2
