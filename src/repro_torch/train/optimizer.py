"""AdamW with a cosine schedule and global-norm clipping (port of
``repro.train.optimizer``).

Functions on tensors, not ``torch.optim``: the state is ``AdamWState(step,
m, v)`` with ``m`` and ``v`` dicts keyed by parameter name, f32 whatever
the parameters' dtype (after an update, ``mu_dtype``: the reference's
bf16 escape hatch), and ``adamw_update`` does the reference's arithmetic
in f32 and writes each new value, cast back to the parameter's dtype, into
the parameter in place.  f32 ``m`` and ``v`` are updated in place too (the
reference returns new arrays; the port keeps one copy of the 8 bytes a
parameter the state takes).

Weight decay follows the reference's rule, ``p.ndim >= 2`` on its own
leaves.  The reference stacks every block leaf over the pattern's repeats,
so a block's 1-D leaves (norm gains, the qkv bias, the RG-LRU and Mamba2
vectors) are rank 2 there and are decayed; the port holds one module per
layer, so it decides by the reference's rank (``reference_ndim``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor              # () int32, on the parameters' device
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    mu_dtype: torch.dtype = torch.float32


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then a cosine down to
    ``min_lr_frac`` of ``lr`` at ``total_steps`` (f32)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(model: torch.nn.Module) -> AdamWState:
    """Zero f32 moments for every parameter of ``model``, on its device."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank the reference's leaf of parameter ``name`` has: a block's
    leaves carry one more axis there (stacked over repeats)."""
    return p.ndim + (1 if name.startswith("blocks.") else 0)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, model: torch.nn.Module,
                 grads: dict[str, torch.Tensor], state: AdamWState):
    """One AdamW step on ``model``'s parameters, in place.  ``grads``: by
    parameter name, any float dtype.  Returns (new state, {"grad_norm",
    "lr"}) -- the state's ``m`` and ``v`` are the updated input dicts."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    for name, p in model.named_parameters():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        mf, vf = m.float(), v.float()        # m, v themselves in f32
        mf.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        vf.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if reference_ndim(name, p) >= 2:   # decoupled decay on matrices
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        if mf is not m or m.dtype != cfg.mu_dtype:
            state.m[name] = mf.to(cfg.mu_dtype)
            state.v[name] = vf.to(cfg.mu_dtype)
    return (AdamWState(step=step, m=state.m, v=state.v),
            {"grad_norm": gnorm, "lr": lr})
