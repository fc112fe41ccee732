"""RG-LRU recurrent block (RecurrentGemma / Griffin), port of
``repro.models.rglru``.

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_x x_t) * x_t)

Prefill runs a doubling scan over (log a, b) pairs -- O(log S) depth,
parallel across (batch, width) lanes, the port of the reference's
``jax.lax.associative_scan`` over the same ``combine`` (equal to rounding).
Decode carries h: O(1) per token.

The recurrence is the solve of a bidiagonal lower-triangular system
(I - shift(a)) h = b; ``examples/rnn_as_trisolve.py`` runs the same scan
beside the HBMC lane-major solve.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init

_C = 8.0


def linear_combine(c1, c2):
    """``h -> a h + b`` composed: ``c1`` then ``c2``."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def log_combine(c1, c2):
    """``linear_combine`` with the decays carried as ``log a``."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 + a2, torch.exp(a2) * b1 + b2


def doubling_scan(a: torch.Tensor, b: torch.Tensor,
                  combine=linear_combine) -> torch.Tensor:
    """Inclusive scan of ``combine`` along dim 1 in ceil(log2 T) levels
    (Hillis-Steele): at level d every position t >= d combines the partial
    result at t - d with its own.  Returns the b (state) part."""
    d = 1
    while d < a.shape[1]:
        a_new, b_new = combine((a[:, :-d], b[:, :-d]), (a[:, d:], b[:, d:]))
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
        d *= 2
    return b


class RGLRU(nn.Module):
    def __init__(self, gen, d: int, rw: int, conv_width: int, dtype):
        super().__init__()
        dev = gen.device
        self.in_x = dense_init(gen, (d, rw), dtype)
        self.in_y = dense_init(gen, (d, rw), dtype)
        self.conv = nn.Parameter(
            (torch.randn((conv_width, rw), generator=gen, device=dev)
             * 0.1).to(dtype))
        self.gate_a = dense_init(gen, (rw, rw), dtype)
        self.gate_x = dense_init(gen, (rw, rw), dtype)
        self.lamb = nn.Parameter(torch.linspace(0.5, 4.0, rw, device=dev)
                                 .to(dtype))              # Lambda init
        self.out = dense_init(gen, (rw, d), dtype)


def causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (cw, C).

    With ``state`` (B, cw-1, C) it continues a stream (decode) and returns
    the updated state."""
    cw = w.shape[0]
    if state is None:
        pad = F.pad(x, (0, 0, cw - 1, 0))
    else:
        pad = torch.cat([state, x], dim=1)
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    new_state = pad[:, -(cw - 1):] if cw > 1 else None
    return out, new_state


def _rglru_core(u, ga, gx, lamb):
    """Shared gate math.  u: (..., rw) pre-activation input."""
    log_a = -_C * F.softplus(lamb.float()) * torch.sigmoid((u @ ga).float())
    gated = torch.sigmoid((u @ gx).float()) * u.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    return log_a, b


def rglru_apply(p, x, h0=None, conv_state=None):
    """x: (B, S, d).  Returns (y, (h_last, conv_state)).

    h0: (B, rw) carried state (None = zeros); conv_state: (B, cw-1, rw)."""
    s = x.shape[1]
    u = x @ p.in_x                                        # (B, S, rw)
    branch = F.gelu(x @ p.in_y, approximate="tanh")
    u, conv_state = causal_conv(u, p.conv, conv_state)
    log_a, b = _rglru_core(u, p.gate_a, p.gate_x, p.lamb)

    if s == 1:                                            # decode
        h_prev = torch.zeros_like(b[:, 0]) if h0 is None else h0
        h = torch.exp(log_a[:, 0]) * h_prev + b[:, 0]
        hs = h[:, None]
    else:
        if h0 is not None:
            # fold the carried state in as a virtual step 0
            log_a = torch.cat([torch.zeros_like(log_a[:, :1]), log_a], dim=1)
            b = torch.cat([h0.to(b.dtype)[:, None], b], dim=1)
        hs = doubling_scan(log_a, b, log_combine)
        if h0 is not None:
            hs = hs[:, 1:]
        h = hs[:, -1]

    y = (hs.to(x.dtype) * branch) @ p.out
    return y, (h, conv_state)
