"""The flash attention core's forward (port of ``repro.models.flash_vjp``).

A chunked online softmax: for each query chunk, a pass over the key/value
chunks keeps the running max ``m``, the running sum ``l`` and the
unnormalised output ``o`` in f32, so no ``(Sq, Skv)`` score tensor exists.
The backward (a ``torch.autograd.Function`` that recomputes the chunks
from the forward's ``lse``) comes with training.

Shapes follow ``layers.flash_attention``: q (B,Sq,KV,G,hd), k/v
(B,Skv,KV,hd), already padded to whole chunks; positions carry the
causal/window mask.
"""
from __future__ import annotations

import math

import torch

from .layers import NEG_INF, causal_mask


def flash_core(q, k, v, q_positions, kv_positions, window, q_chunk,
               kv_chunk) -> torch.Tensor:
    """Attention output (B, Sq, KV, G, hd) in q's dtype."""
    b, sq, kv, g, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    nq, nk = sq // q_chunk, skv // kv_chunk
    qs = q.reshape(b, nq, q_chunk, kv, g, hd)
    qp = q_positions.reshape(nq, q_chunk)
    ks = k.reshape(b, nk, kv_chunk, kv, hd)
    vs = v.reshape(b, nk, kv_chunk, kv, hd)
    kp = kv_positions.reshape(nk, kv_chunk)

    outs = []
    for i in range(nq):
        qc, qpc = qs[:, i], qp[i]
        m = torch.full((b, kv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        o = torch.zeros((b, kv, g, q_chunk, hd), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            s = torch.einsum("btkgh,bukh->bkgtu", qc, ks[:, j]) * scale
            s = torch.where(causal_mask(qpc, kp[j], window), s.float(),
                            NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            a0 = torch.exp(m - m_new)
            l = l * a0 + torch.sum(p, dim=-1)
            o = o * a0[..., None] + torch.einsum("bkgtu,bukh->bkgth", p,
                                                 vs[:, j].float())
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((o / l[..., None]).to(q.dtype))       # (B,KV,G,Tq,hd)
    # (B, nq, KV, G, Tq, hd) -> (B, Sq, KV, G, hd)
    return torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5) \
        .reshape(b, sq, kv, g, hd)
