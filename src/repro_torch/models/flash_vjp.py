"""Flash attention with a chunk-recomputing backward (port of
``repro.models.flash_vjp``).

The forward is a chunked online softmax: for each query chunk, a pass over
the key/value chunks keeps the running max ``m``, the running sum ``l`` and
the unnormalised output ``o`` in f32, so no ``(Sq, Skv)`` score tensor
exists.  ``flash_core`` is a ``torch.autograd.Function`` whose backward
recomputes ``p = exp(s - lse)`` per (q-chunk, kv-chunk) tile from the
forward's ``lse = m + log l`` instead of saving per-chunk residuals:

  saved for the backward: q, k, v, o, lse and the positions (all O(S))
  backward:  D = rowsum(do * o)
             per tile: p   = exp(s - lse)
                       dv += p^T do
                       dp  = do v^T
                       ds  = p * (dp - D) * scale
                       dq += ds k ;  dk += ds^T q

all in f32, the gradients cast back to the inputs' dtypes.

Shapes follow ``layers.flash_attention``: q (B,Sq,KV,G,hd), k/v
(B,Skv,KV,hd), already padded to whole chunks; positions carry the
causal/window mask.
"""
from __future__ import annotations

import math

import torch

from .layers import NEG_INF, causal_mask


def _flash_fwd_impl(q, k, v, qpos, kpos, window, q_chunk, kv_chunk):
    """(o (B,Sq,KV,G,hd) in q's dtype, lse (B,Sq,KV,G) f32)."""
    b, sq, kv, g, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    nq, nk = sq // q_chunk, skv // kv_chunk
    qs = q.reshape(b, nq, q_chunk, kv, g, hd)
    qp = qpos.reshape(nq, q_chunk)
    ks = k.reshape(b, nk, kv_chunk, kv, hd)
    vs = v.reshape(b, nk, kv_chunk, kv, hd)
    kp = kpos.reshape(nk, kv_chunk)

    outs, lses = [], []
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
        lses.append(m + torch.log(l))                     # (B,KV,G,Tq)
    # (B, nq, KV, G, Tq, hd) -> (B, Sq, KV, G, hd)
    o = torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5) \
        .reshape(b, sq, kv, g, hd)
    # (B, nq, KV, G, Tq) -> (B, Sq, KV, G)
    lse = torch.stack(lses, dim=1).permute(0, 1, 4, 2, 3) \
        .reshape(b, sq, kv, g)
    return o, lse


def _flash_bwd_impl(q, k, v, qpos, kpos, o, lse, do, window, q_chunk,
                    kv_chunk):
    """(dq, dk, dv) in the dtypes of q, k, v; the reference's ``_bwd``."""
    b, sq, kv, g, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    nq, nk = sq // q_chunk, skv // kv_chunk
    # D = rowsum(do * o): (B,Sq,KV,G)
    d_ = torch.sum(do.float() * o.float(), dim=-1)

    qs = q.reshape(b, nq, q_chunk, kv, g, hd)
    dos = do.reshape(b, nq, q_chunk, kv, g, hd)
    ds_ = d_.reshape(b, nq, q_chunk, kv, g)
    lses = lse.reshape(b, nq, q_chunk, kv, g)
    qp = qpos.reshape(nq, q_chunk)
    ks = k.reshape(b, nk, kv_chunk, kv, hd)
    vs = v.reshape(b, nk, kv_chunk, kv, hd)
    kp = kpos.reshape(nk, kv_chunk)

    # accumulated out of place, from the first chunk's terms (an in-place
    # += on a zeros buffer gives the same bits and DTensor refuses it)
    dk = dv = None
    dqs = []
    for i in range(nq):
        qc, qpc = qs[:, i], qp[i]
        lse_t = lses[:, i].permute(0, 2, 3, 1)            # (B,KV,G,Tq)
        do_t = dos[:, i].permute(0, 2, 3, 1, 4).float()   # (B,KV,G,Tq,hd)
        d_t = ds_[:, i].permute(0, 2, 3, 1)               # (B,KV,G,Tq)
        dq = None
        dk_cs, dv_cs = [], []
        for j in range(nk):
            kc, vc = ks[:, j], vs[:, j]
            s = torch.einsum("btkgh,bukh->bkgtu", qc, kc) * scale
            s = torch.where(causal_mask(qpc, kp[j], window), s.float(),
                            NEG_INF)
            p = torch.exp(s - lse_t[..., None])           # (B,KV,G,Tq,Tk)
            dv_cs.append(torch.einsum("bkgtu,bkgth->bukh", p, do_t))
            dp = torch.einsum("bkgth,bukh->bkgtu", do_t, vc.float())
            dsx = p * (dp - d_t[..., None]) * scale
            dq_j = torch.einsum("bkgtu,bukh->btkgh", dsx, kc.float())
            dq = dq_j if dq is None else dq + dq_j
            dk_cs.append(torch.einsum("bkgtu,btkgh->bukh", dsx, qc.float()))
        dk_i, dv_i = torch.stack(dk_cs, dim=1), torch.stack(dv_cs, dim=1)
        dk = dk_i if dk is None else dk + dk_i
        dv = dv_i if dv is None else dv + dv_i
        dqs.append(dq)
    dq = torch.stack(dqs, dim=1).reshape(b, sq, kv, g, hd).to(q.dtype)
    return (dq, dk.reshape(b, skv, kv, hd).to(k.dtype),
            dv.reshape(b, skv, kv, hd).to(v.dtype))


class _FlashCore(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` of ``flash_core``."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, window, q_chunk,
                kv_chunk):
        o, lse = _flash_fwd_impl(q, k, v, q_positions, kv_positions, window,
                                 q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, o, lse)
        ctx.window, ctx.q_chunk, ctx.kv_chunk = window, q_chunk, kv_chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, qpos, kpos, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, qpos, kpos, o, lse, do,
                                     ctx.window, ctx.q_chunk, ctx.kv_chunk)
        return dq, dk, dv, None, None, None, None, None


def flash_core(q, k, v, q_positions, kv_positions, window, q_chunk,
               kv_chunk) -> torch.Tensor:
    """Attention output (B, Sq, KV, G, hd) in q's dtype; differentiable in
    q, k and v through the chunk-recomputing backward."""
    return _FlashCore.apply(q, k, v, q_positions, kv_positions, window,
                            q_chunk, kv_chunk)
