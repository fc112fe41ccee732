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
    t = b * s
    xf = x.reshape(t, d)
    n_experts = p.router.shape[-1]
    logits = (xf @ p.router).float()                          # (T, E)
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
    buf = torch.zeros((n_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    src = torch.repeat_interleave(xf, top_k, dim=0)
    w = keep.reshape(-1, 1).to(x.dtype)
    buf.index_put_((e_flat, c_flat), src * w, accumulate=True)

    out = mlp_apply(p.experts, buf, act)                      # (E, C, d)

    # combine
    gathered = out[e_flat, c_flat]                            # (T*k, d)
    y = torch.sum((gathered * gate.reshape(-1, 1).to(x.dtype))
                  .reshape(t, top_k, d), dim=1)
    return y.reshape(b, s, d), logits


def load_balancing_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (mean prob * mean assignment)."""
    probs = torch.softmax(router_logits, dim=-1)
    e = probs.shape[-1]
    frac_prob = torch.mean(probs, dim=0)
    assign = F.one_hot(torch.argmax(probs, dim=-1), e).float()
    frac_tokens = torch.mean(assign, dim=0)
    return e * torch.sum(frac_prob * frac_tokens)
