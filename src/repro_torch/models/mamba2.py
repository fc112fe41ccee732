"""Mamba2 block -- SSD (state-space duality) with a chunked scan, port of
``repro.models.mamba2``.

Prefill runs the SSD chunked algorithm: masked quadratic work within
fixed-size chunks (in the activation dtype, f32 accumulation) plus a
sequential inter-chunk state recurrence of length S / chunk.  Decode
carries the (H, P, N) state: O(1) per token, a different formula from the
chunked path.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..dist.constraints import BATCH, constrain
from .layers import dense_init, pad_seq, randn, rmsnorm
from .rglru import causal_conv


class Mamba2(nn.Module):
    def __init__(self, gen, d: int, state: int, head_dim: int,
                 conv_width: int, dtype):
        super().__init__()
        dev = gen.device
        d_in = 2 * d
        nheads = d_in // head_dim
        conv_dim = d_in + 2 * state
        self.in_proj = dense_init(gen, (d, 2 * d_in + 2 * state + nheads),
                                  dtype)
        self.conv = nn.Parameter(
            (randn(gen, (conv_width, conv_dim)) * 0.1).to(dtype))
        self.a_log = nn.Parameter(
            torch.log(torch.linspace(1.0, 16.0, nheads, device=dev))
            .to(dtype))
        self.d_skip = nn.Parameter(torch.ones(nheads, device=dev,
                                              dtype=dtype))
        self.dt_bias = nn.Parameter(torch.zeros(nheads, device=dev,
                                                dtype=dtype))
        self.norm = nn.Parameter(torch.zeros(d_in, device=dev, dtype=dtype))
        self.out_proj = dense_init(gen, (d_in, d), dtype)


def _dot_f32(eq: str, *ops) -> torch.Tensor:
    """``einsum`` with f32 accumulation (``preferred_element_type=f32``):
    the operands are upcast, which is exact for products of bf16."""
    return torch.einsum(eq, *(o.float() for o in ops))


def _chunk_terms(xc, dtc, bc, cc, a, *, cdt):
    """The chunk-local part of the SSD scan: (y_intra (B,nc,Q,H,P), the
    chunks' input states sc (B,nc,H,P,N), the inclusive decay sums cum
    (B,nc,Q,H))."""
    chunk = xc.shape[2]
    da = dtc * a.float()                                  # (B,nc,Q,H)
    cum = torch.cumsum(da, dim=2)                         # inclusive

    # intra-chunk, masked before exp; (B,nc,Q,Q,H) in the activation dtype
    diff = cum[:, :, :, None] - cum[:, :, None, :]        # (B,nc,Qi,Qj,H)
    iq = torch.arange(chunk, device=xc.device)
    mask = iq[:, None] >= iq[None, :]
    diff = torch.where(mask[None, None, :, :, None], diff, -torch.inf)
    lmat = torch.exp(diff).to(cdt)
    cb = _dot_f32("bcin,bcjn->bcij", cc, bc).to(cdt)
    w = cb[..., None] * lmat * dtc[:, :, None].to(cdt)
    y_intra = _dot_f32("bcijh,bcjhp->bcihp", w, xc)

    # per-chunk input states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,H)
    sc = _dot_f32("bcqh,bcqn,bcqhp->bchpn", (decay_to_end * dtc).to(cdt),
                  bc, xc)                                 # (B,nc,H,P,N)
    return y_intra, sc, cum


def _per_chunk(fn, chunked, shared=(), n_out: int = 1):
    """``fn(*chunked, *shared)``, each output laid out (B, nc, ...) as the
    ``chunked`` inputs.  On DTensors, on each device's (batch, chunk)
    shards (``local_map``): the work is chunk-local, the ``shared``
    inputs whole on every device (their gradients partial sums), and no
    DTensor rule is needed for the einsums' flattening of two sharded dims
    (which torch 2.11's refuses) or for the cumsum's backward (a flip)."""
    lead = chunked[0]
    if not isinstance(lead, DTensor):
        return fn(*chunked, *shared)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(lead.placements)
    whole = (Replicate(),) * len(pl)
    part = tuple(Replicate() if q == Replicate() else Partial() for q in pl)
    k = len(chunked)
    return local_map(fn, out_placements=(pl,) * n_out,
                     in_placements=(pl,) * k + (whole,) * len(shared),
                     in_grad_placements=(pl,) * k + (part,) * len(shared),
                     device_mesh=lead.device_mesh,
                     redistribute_inputs=True)(*chunked, *shared)


def ssd_chunked(x, dt, a, b_, c_, chunk: int):
    """SSD scan.  x: (B,L,H,P); dt: (B,L,H); a: (H,) negative;
    b_, c_: (B,L,N).  Returns y: (B,L,H,P) and final state (B,H,P,N) f32."""
    bsz, l, h, p = x.shape
    n = b_.shape[-1]
    pad = (-l) % chunk
    if pad:
        x, dt, b_, c_ = (pad_seq(t, 0, pad) for t in (x, dt, b_, c_))
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b_.reshape(bsz, nc, chunk, n)
    cc = c_.reshape(bsz, nc, chunk, n)

    # chunk axis = sequence parallelism over the TP mesh axis: intra-chunk
    # quadratic work is chunk-local, so the (B, nc, Q, Q, H) tensors shard
    # cleanly over `model`; only the small inter-chunk states cross it
    xc = constrain(xc, BATCH, "model", None, None, None)
    bc = constrain(bc, BATCH, "model", None, None)
    cc = constrain(cc, BATCH, "model", None, None)
    dtc = constrain(dtc, BATCH, "model", None, None)

    cdt = x.dtype
    y_intra, sc, cum = _per_chunk(
        functools.partial(_chunk_terms, cdt=cdt), (xc, dtc, bc, cc), (a,),
        n_out=3)
    seg = cum[:, :, -1:]                                  # (B,nc,1,H)

    # inter-chunk recurrence
    chunk_decay = torch.exp(seg[:, :, 0])                 # (B,nc,H)
    s = torch.zeros_like(sc[:, 0])                        # (B,H,P,N) f32
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + sc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                 # (B,nc,H,P,N)

    y_inter = _per_chunk(lambda cc, sp, cum: _dot_f32(
        "bcqn,bchpn,bcqh->bcqhp", cc, sp.to(cdt), torch.exp(cum).to(cdt)),
        (cc, s_prevs, cum))
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, h, p)[:, :l]
    return y.to(x.dtype), s


def mamba2_apply(p, u, state=None, conv_state=None, *, d_model, ssm_state,
                 head_dim, chunk):
    """u: (B, S, d).  Returns (y, (ssm_state, conv_state))."""
    d_in = 2 * d_model
    nheads = d_in // head_dim
    bsz, s, _ = u.shape
    # the fused projection whole on each device before its split (a
    # DTensor may otherwise leave its last dim unevenly scattered)
    z, xbc, dt = torch.split(constrain(u @ p.in_proj, BATCH, None, None),
                             [d_in, d_in + 2 * ssm_state, nheads], dim=-1)
    xbc, conv_state = causal_conv(xbc, p.conv, conv_state)
    xbc = F.silu(xbc)
    x, b_, c_ = torch.split(xbc, [d_in, ssm_state, ssm_state], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())
    xh = x.reshape(bsz, s, nheads, head_dim)

    if s == 1:                                            # decode
        h_prev = (torch.zeros((bsz, nheads, head_dim, ssm_state),
                              dtype=torch.float32, device=u.device)
                  if state is None else state)
        da = torch.exp(dt[:, 0] * a)                      # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], b_[:, 0].float(),
                           xh[:, 0].float())
        h = h_prev * da[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_[:, 0].float(), h)
        y = y[:, None].to(u.dtype)
        state = h
    else:
        y, state = ssd_chunked(xh, dt, a, b_, c_, chunk)

    y = y + xh.to(y.dtype) * p.d_skip.to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, d_in)
    y = rmsnorm(y * F.silu(z.to(y.dtype)), p.norm)
    # the sequence gathered for the out projection (a sharded matmul
    # cannot flatten a sequence sharded after the batch)
    return (constrain(y, BATCH, None, None) @ p.out_proj,
            (state, conv_state))
