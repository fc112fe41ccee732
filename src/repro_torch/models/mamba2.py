"""Mamba2 block -- SSD (state-space duality) with a chunked scan, port of
``repro.models.mamba2``.

Prefill runs the SSD chunked algorithm: masked quadratic work within
fixed-size chunks (in the activation dtype, f32 accumulation) plus a
sequential inter-chunk state recurrence of length S / chunk.  Decode
carries the (H, P, N) state: O(1) per token, a different formula from the
chunked path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init, rmsnorm
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
            (torch.randn((conv_width, conv_dim), generator=gen, device=dev)
             * 0.1).to(dtype))
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


def ssd_chunked(x, dt, a, b_, c_, chunk: int):
    """SSD scan.  x: (B,L,H,P); dt: (B,L,H); a: (H,) negative;
    b_, c_: (B,L,N).  Returns y: (B,L,H,P) and final state (B,H,P,N) f32."""
    bsz, l, h, p = x.shape
    n = b_.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_ = F.pad(b_, (0, 0, 0, pad))
        c_ = F.pad(c_, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b_.reshape(bsz, nc, chunk, n)
    cc = c_.reshape(bsz, nc, chunk, n)

    da = dtc * a.float()                                  # (B,nc,Q,H)
    cum = torch.cumsum(da, dim=2)                         # inclusive
    seg = cum[:, :, -1:]                                  # (B,nc,1,H)

    # intra-chunk, masked before exp; (B,nc,Q,Q,H) in the activation dtype
    cdt = x.dtype
    diff = cum[:, :, :, None] - cum[:, :, None, :]        # (B,nc,Qi,Qj,H)
    iq = torch.arange(chunk, device=x.device)
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

    # inter-chunk recurrence
    chunk_decay = torch.exp(seg[:, :, 0])                 # (B,nc,H)
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + sc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                 # (B,nc,H,P,N)

    y_inter = _dot_f32("bcqn,bchpn,bcqh->bcqhp", cc, s_prevs.to(cdt),
                       torch.exp(cum).to(cdt))
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, h, p)[:, :l]
    return y.to(x.dtype), s


def mamba2_apply(p, u, state=None, conv_state=None, *, d_model, ssm_state,
                 head_dim, chunk):
    """u: (B, S, d).  Returns (y, (ssm_state, conv_state))."""
    d_in = 2 * d_model
    nheads = d_in // head_dim
    bsz, s, _ = u.shape
    z, xbc, dt = torch.split(u @ p.in_proj,
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
    return y @ p.out_proj, (state, conv_state)
