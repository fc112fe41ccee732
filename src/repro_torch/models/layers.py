"""Shared layer library: norms, RoPE/M-RoPE, attention (full/windowed,
memory-chunked), MLPs -- the port of ``repro.models.layers``.

Parameters live on ``nn.Module`` attributes under the reference's names
(weights stored ``(in, out)`` as the reference's, so ``x @ w`` is the same
product); the functions here read them by attribute.

Attention keeps the reference's own arithmetic in PyTorch ops: an online
softmax over key/value chunks with masks set to ``NEG_INF`` and padded keys
at position ``2**30``, so no ``(S, S)`` score tensor is built.  Windowed
attention takes a static-size KV band per query chunk (linear in S).  The
reference's context-parallel prefill path exists to shard the query chunks
over a mesh; on one device it is the same online softmax as
``flash_vjp.flash_core``, which the port runs in its place (one query chunk
of temporaries at a time).  On a mesh (DTensors under ``dist.use_mesh``)
the attention runs on each device's heads and batch rows under
``local_map`` (``_head_local``): `model` splits the KV heads, or G where it
does not divide KV.
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.constraints import BATCH, _current_mesh, constrain, divides

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------


#: the weight source of ``transformer.param_specs``: allocates on the meta
#: device and draws nothing (the reference's ``jax.eval_shape``)
META_INIT = SimpleNamespace(device=torch.device("meta"))


def randn(gen, shape) -> torch.Tensor:
    """Standard normal f32 draws from ``gen`` on ``gen``'s device; on the
    meta device (``META_INIT``) an empty tensor of the shape."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None) -> nn.Parameter:
    """A weight drawn from ``gen`` (on ``gen``'s device): standard normal
    times ``scale`` (default ``1/sqrt(shape[0])``), drawn in f32 and cast."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return nn.Parameter((randn(gen, shape) * scale).to(dtype))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + gamma``, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def apply_norm(x, p, kind: str, eps: float):
    """``p``: a module with ``scale`` (and ``bias`` for layernorm)."""
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale, eps)
    return layernorm(x, p.scale, p.bias, eps)


class Norm(nn.Module):
    """RMSNorm (``scale`` zeros: the weight is ``1 + scale``) or LayerNorm
    (``scale`` ones, ``bias`` zeros)."""

    def __init__(self, d: int, kind: str, eps: float, *, device, dtype):
        super().__init__()
        self.kind, self.eps = kind, eps
        if kind == "rmsnorm":
            self.scale = nn.Parameter(torch.zeros(d, device=device,
                                                  dtype=dtype))
        else:
            self.scale = nn.Parameter(torch.ones(d, device=device,
                                                 dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(d, device=device,
                                                 dtype=dtype))

    def forward(self, x):
        return apply_norm(x, self, self.kind, self.eps)


def pad_seq(x: torch.Tensor, before: int, after: int = 0) -> torch.Tensor:
    """``x`` with ``before`` / ``after`` zero positions along dim 1:
    ``F.pad``'s result, by concatenation (DTensor's sharding rule for pad
    is wrong in some torch versions: it gives one placement on a 2-D
    mesh)."""
    z = torch.zeros_like(x[:, :1])
    parts = [z.expand(x.shape[0], n, *x.shape[2:]) if n else None
             for n in (before, after)]
    return torch.cat([t for t in (parts[0], x, parts[1]) if t is not None],
                     dim=1)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE for Qwen2-VL)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _section_ids(sections: tuple, n: int, device) -> torch.Tensor:
    """Which position axis each of the ``n`` frequency slots reads: section
    ``s`` repeated ``sections[s]`` times, cut or padded with the last value
    to ``n`` (``jnp.repeat(..., total_repeat_length=n)``)."""
    ids = [s for s, size in enumerate(sections) for _ in range(size)]
    ids = (ids + ids[-1:] * n)[:n]
    return torch.tensor(ids, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               m_rope_sections: Optional[tuple] = None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (3, B, S) for M-RoPE.

    Rotates split halves; the angles are f32, the rotation runs in x's
    dtype."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    if positions.ndim == 3:                               # M-RoPE
        if m_rope_sections is None:
            raise ValueError("(3, B, S) positions need m_rope_sections")
        sec = _section_ids(m_rope_sections, hd // 2, x.device)
        ang_all = positions[..., None].float() * inv      # (3,B,S,hd/2)
        ang = torch.gather(ang_all.movedim(0, -1),        # (B,S,hd/2,3)
                           -1, sec[None, None, :, None].expand(
                               *ang_all.shape[1:], 1))[..., 0]
    else:
        ang = positions[..., None].float() * inv          # (B,S,hd/2)
    cos = torch.cos(ang).to(x.dtype)[:, :, None, :]        # (B,S,1,hd/2)
    sin = torch.sin(ang).to(x.dtype)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------

def causal_mask(qpos: torch.Tensor, kpos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """``(..., Tq, Tk)`` keep-mask: causal, and inside ``window``."""
    m = kpos[..., None, :] <= qpos[..., :, None]
    if window is not None:
        m &= kpos[..., None, :] > (qpos[..., :, None] - window)
    return m


def _attend_block(q, k, v, qpos, kpos, window, scale):
    """One (q-chunk, kv band) softmax block.

    q: (B, Tq, KV, G, hd); k/v: (B, Tk, KV, hd).  Returns (max, sum,
    weighted v) with the weighted v in v's dtype."""
    s = torch.einsum("btkgh,bukh->bkgtu", q, k) * scale   # (B,KV,G,Tq,Tk)
    s = torch.where(causal_mask(qpos, kpos, window), s.float(), NEG_INF)
    m = torch.amax(s, dim=-1)                              # (B,KV,G,Tq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    pv = torch.einsum("bkgtu,bukh->bkgth", p.to(v.dtype), v)
    return m, l, pv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    *, window: Optional[int] = None,
                    q_chunk: int = 1024, kv_chunk: int = 4096
                    ) -> torch.Tensor:
    """Causal (optionally windowed) attention without an (S, S) score
    tensor.

    q: (B, Sq, H, hd) with H = KV * G (head ``h = kv * G + g``);  k, v:
    (B, Skv, KV, hd).  q_positions: (Sq,) absolute positions;
    kv_positions: (Skv,).  Returns (B, Sq, H, hd).
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    q = q.reshape(b, sq, kv, g, hd)
    g_sharded = not divides("model", kv)
    if g_sharded:
        # heads over `model` through G where it cannot go through KV (the
        # reference's mesh path shards query chunks instead)
        q = constrain(q, BATCH, None, None, "model", None)

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nk = -(-skv // kv_chunk)
    # pad to whole chunks (padding keys get position 2**30: fully masked)
    qpad, kpad = nq * q_chunk - sq, nk * kv_chunk - skv
    if qpad:
        q = pad_seq(q, 0, qpad)
        q_positions = F.pad(q_positions, (0, qpad))
    if kpad:
        k, v = pad_seq(k, 0, kpad), pad_seq(v, 0, kpad)
        kv_positions = F.pad(kv_positions, (0, kpad), value=2**30)

    out5 = _head_local(_attend_chunks, q, k, v, q_positions, kv_positions,
                       g_sharded, window=window, q_chunk=q_chunk,
                       kv_chunk=kv_chunk)                 # (B,Sq,KV,G,hd)
    return _merge_heads(out5, (b, nq * q_chunk, h, hd), g_sharded)[:, :sq]


def _attend_chunks(q, k, v, q_positions, kv_positions, *, window, q_chunk,
                   kv_chunk) -> torch.Tensor:
    """Attention of q (B, nq * Tq, KV, G, hd) over k / v (B, nk * Tk, KV,
    hd), padded to whole chunks: a static-size KV band per query chunk
    where a window is shorter than the keys, else ``flash_core``.
    Returns (B, nq * Tq, KV, G, hd)."""
    b, sqp, kv, g, hd = q.shape
    nq, nk = sqp // q_chunk, k.shape[1] // kv_chunk
    band = (-(-((window or 0) + q_chunk) // kv_chunk) + 1) * kv_chunk
    if window is not None and nk * kv_chunk > band:
        # static-size KV band per query chunk: linear-in-S total work
        scale = 1.0 / math.sqrt(hd)
        qs = q.reshape(b, nq, q_chunk, kv, g, hd)
        qp = q_positions.reshape(nq, q_chunk)
        outs = []
        for qi in range(nq):
            start = min(max(qi * q_chunk + q_chunk - band, 0),
                        nk * kv_chunk - band)
            _, l, pv = _attend_block(qs[:, qi], k[:, start:start + band],
                                     v[:, start:start + band], qp[qi],
                                     kv_positions[start:start + band],
                                     window, scale)
            outs.append(pv / torch.clamp(l, min=1e-30)[..., None]
                        .to(pv.dtype))                    # (B,KV,G,Tq,hd)
        out = torch.stack(outs, dim=1)                    # (B,nq,KV,G,Tq,hd)
        return out.permute(0, 1, 4, 2, 3, 5).reshape(b, sqp, kv, g, hd)

    from .flash_vjp import flash_core
    return flash_core(q, k, v, q_positions, kv_positions, window, q_chunk,
                      kv_chunk)


def _head_local(fn, q, k, v, q_positions, kv_positions, g_sharded: bool,
                **kw) -> torch.Tensor:
    """``fn(q, k, v, q_positions, kv_positions, **kw)`` with q (B, S, KV,
    G, hd); on DTensors under an active mesh, on each device's own heads
    and batch rows (``local_map``): q split over `model` on KV, or on G
    where ``g_sharded`` (k / v then whole on every device, their
    gradients partial sums over `model`), the batch over its batch axes,
    DTensor positions as they are.  The attention's ops then run on plain
    tensors, its backward too."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = _current_mesh()
    if mesh is None or not isinstance(q, DTensor):
        return fn(q, k, v, q_positions, kv_positions, **kw)
    from torch.distributed.tensor.experimental import local_map

    from ..dist.sharding import _batch_entry, mesh_placement
    entry = _batch_entry(mesh, q.shape[0])
    batch = (entry,) if isinstance(entry, str) else tuple(entry or ())
    q_model = (Shard(3) if divides("model", q.shape[3]) else None) \
        if g_sharded else Shard(2)
    kv_model = None if g_sharded else Shard(2)
    kv_grad = (Partial() if q_model is not None else None) if g_sharded \
        else Shard(2)

    def place(model):
        return tuple(mesh_placement(mesh, a, Shard(0) if a in batch
                                    else model if a == "model" else None)
                     for a in mesh.mesh_dim_names)
    def own(t):         # positions: as they are (a decode's by batch)
        return tuple(t.placements) if isinstance(t, DTensor) else None
    qp, kvp, kvg = place(q_model), place(kv_model), place(kv_grad)
    pos = (own(q_positions), own(kv_positions))
    return local_map(
        functools.partial(fn, **kw), out_placements=(qp,),
        in_placements=(qp, kvp, kvp) + pos,
        in_grad_placements=(qp, kvg, kvg) + pos,
        device_mesh=mesh, redistribute_inputs=True,
    )(q, k, v, q_positions, kv_positions)


def _merge_heads(o, shape, g_sharded: bool) -> torch.Tensor:
    """``o`` (B, ..., KV, G, hd) reshaped to ``shape`` (B, S, H, hd).  With
    G on `model` the heads are gathered first, and the gradient before the
    backward's split: a DTensor reshape cannot merge or split a shard of
    an inner dim."""
    if not g_sharded:
        return o.reshape(shape)
    o = constrain(o, BATCH, *(None,) * (o.ndim - 1))
    return constrain(o.reshape(shape), BATCH, None, None, None)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_position: torch.Tensor,
                     kv_positions: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffer) KV cache.

    q: (B, 1, H, hd); caches: (B, C, KV, hd); q_position: (B,);
    kv_positions: (B, C) absolute positions of the cache slots (-1 for
    empty).  The mask covers both validity and the window.  A cache in
    another dtype than q is promoted as jnp promotes; the output is in
    v_cache's dtype.
    """
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    g_sharded = not divides("model", kv)
    q = q.reshape(b, 1, kv, h // kv, hd)
    if g_sharded:
        q = constrain(q, BATCH, None, None, "model", None)
    o = _head_local(_decode_core, q, k_cache, v_cache, q_position,
                    kv_positions, g_sharded, window=window)
    return _merge_heads(o, (b, 1, h, hd), g_sharded)


def _decode_core(q, k_cache, v_cache, q_position, kv_positions, *,
                 window) -> torch.Tensor:
    """``decode_attention`` on q (B, 1, KV, G, hd); (B, 1, KV, G, hd)."""
    b, _, kv, g, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    dt = torch.promote_types(q.dtype, k_cache.dtype)    # jnp's promotion
    qr = q.reshape(b, kv, g, hd).to(dt)
    s = torch.einsum("bkgh,bukh->bkgu", qr, k_cache.to(dt)) * scale
    valid = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    if window is not None:
        valid &= kv_positions > (q_position[:, None] - window)
    s = torch.where(valid[:, None, None], s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgu,bukh->bkgh", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, kv, g, hd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``gate``, ``up``, ``down``) or a plain GELU MLP (``up``,
    ``down``); ``experts`` > 0 stacks the weights over a leading expert
    axis (the MoE's experts, applied as one batched product)."""

    def __init__(self, gen, d: int, ff: int, act: str, dtype,
                 experts: int = 0):
        super().__init__()
        self.act = act
        lead = (experts,) if experts else ()
        names = ("gate", "up", "down") if act == "silu" else ("up", "down")
        for name in names:
            shape = (ff, d) if name == "down" else (d, ff)
            setattr(self, name, dense_init(gen, lead + shape, dtype,
                                           scale=1.0 / math.sqrt(shape[0])))

    def forward(self, x):
        return mlp_apply(self, x, self.act)


def mlp_apply(p, x, act: str):
    """``p``: an object with ``up`` and ``down`` (and ``gate`` for silu)
    weights; GELU is the tanh form (``jax.nn.gelu``'s default)."""
    if act == "silu":
        h = F.silu(x @ p.gate) * (x @ p.up)
    else:
        h = F.gelu(x @ p.up, approximate="tanh")
    return h @ p.down
