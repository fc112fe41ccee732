"""Mixture-of-experts block with capacity-based dispatch (port of
``repro.models.moe``).

Top-k routing -> tokens scattered into a per-expert (E, C, d) buffer ->
one batched product per expert weight -> weighted combine.  Compute scales
with ``tokens * top_k * capacity_factor``; a token whose queue position in
its expert reaches the capacity is dropped (its gate set to 0).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.constraints import constrain
from .layers import MLP, dense_init, mlp_apply


class MoE(nn.Module):
    """``router`` (d, E) and ``experts``: an ``MLP`` stacked over E."""

    def __init__(self, gen, d: int, ff: int, n_experts: int, act: str,
                 dtype):
        super().__init__()
        self.router = dense_init(gen, (d, n_experts), dtype, scale=0.02)
        self.experts = MLP(gen, d, ff, act, dtype, experts=n_experts)


def moe_apply(p, x, *, top_k: int, capacity_factor: float, act: str):
    """x: (B, S, d) -> ((B, S, d), router logits (B*S, E) in f32).

    ``capacity_factor <= 0`` is exact mode: the capacity is every token."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    logits = (xf @ p.router).float()                          # (T, E)
    y = dispatch_combine(xf, logits, p.experts, top_k=top_k,
                         capacity_factor=capacity_factor, act=act)
    return y.reshape(b, s, d), logits


def dispatch_combine(xf, logits, experts, *, top_k: int,
                     capacity_factor: float, act: str):
    """Route the tokens ``xf`` (T, d) by their router ``logits`` (T, E, f32)
    to the ``experts`` (an MLP stacked over E, or any object with its
    weights), run them on an (E, C, d) buffer and combine: (T, d)."""
    t, d = xf.shape
    n_experts = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)              # (T, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)       # renormalize

    if capacity_factor <= 0:
        capacity = t
    else:
        capacity = max(1, int(t * top_k * capacity_factor / n_experts))
    # position of each (token, slot) within its expert queue
    flat = F.one_hot(idx, n_experts).reshape(t * top_k, n_experts)
    pos = torch.cumsum(flat, dim=0) - 1                       # (T*k, E)
    pos = torch.sum(pos * flat, dim=-1).reshape(t, top_k)     # (T, k)
    keep = pos < capacity
    gate = gate * keep

    # scatter tokens into (E, C, d)
    e_flat = idx.reshape(-1)
    c_flat = torch.clamp(pos.reshape(-1), 0, capacity - 1)
    buf = torch.zeros((n_experts, capacity, d), dtype=xf.dtype,
                      device=xf.device)
    src = torch.repeat_interleave(xf, top_k, dim=0)
    w = keep.reshape(-1, 1).to(xf.dtype)
    buf = buf.index_put((e_flat, c_flat), src * w, accumulate=True)
    # expert parallelism on DTensors: the expert axis on the mesh's `model`
    # axis (dropped gracefully when E % model != 0)
    buf = constrain(buf, "model", None, None)

    out = mlp_apply(experts, buf, act)                        # (E, C, d)
    out = constrain(out, "model", None, None)

    # combine
    gathered = out[e_flat, c_flat]                            # (T*k, d)
    return torch.sum((gathered * gate.reshape(-1, 1).to(xf.dtype))
                     .reshape(t, top_k, d), dim=1)


def load_balancing_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (mean prob * mean assignment)."""
    probs = torch.softmax(router_logits, dim=-1)
    e = probs.shape[-1]
    frac_prob = torch.mean(probs, dim=0)
    assign = F.one_hot(torch.argmax(probs, dim=-1), e).float()
    frac_tokens = torch.mean(assign, dim=0)
    return e * torch.sum(frac_prob * frac_tokens)
