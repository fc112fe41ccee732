"""Training step: loss, gradients, AdamW update (port of
``repro.train.step``).

Gradients come from autograd on the ``Model``'s parameters, with
``torch.autograd.grad`` (no ``.grad`` is written).  ``microbatches > 1``
runs the loss and its gradients once per slice of the batch and sums the
slices' gradients in f32 buffers, as the reference's scan does -- not in
the parameters' dtype -- which divides the activation memory without
touching the math.

On a mesh: a model whose parameters are DTensors (placed by
``dist.params_shardings``) and a batch placed by
``dist.batch_partition_spec`` run through the same code under
``dist.use_mesh(mesh)``; each gradient comes back in its parameter's
placements, the metrics as whole tensors.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..kernels.config import resolve_device
from ..models.config import ArchConfig
from .optimizer import AdamWConfig, AdamWState, adamw_update

AUX_LOSS_WEIGHT = 0.01
XENT_CHUNK = 1024


def make_positions(cfg: ArchConfig, batch: int, seq: int,
                   device="cpu") -> torch.Tensor:
    """(B, S) positions 0..S-1, or (3, B, S) for M-RoPE."""
    p = torch.arange(seq, device=device)[None].expand(batch, seq)
    return p[None].expand(3, batch, seq) if cfg.m_rope else p


def _xent_sum(xc, head, lc):
    """Summed negative log-likelihood of one sequence chunk."""
    logits = (xc @ head).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.gather(logp, -1, lc[..., None]))


def chunked_xent(x, head, labels, chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Mean cross entropy without the full (B, S, V) f32 logits: one
    ``checkpoint`` per sequence chunk, so the backward recomputes a chunk's
    logits (one product) instead of keeping them.  A sequence that is not a
    whole number of chunks is one chunk, as in the reference."""
    b, s = labels.shape
    if s % chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        total = total + checkpoint(_xent_sum, x[:, c:c + chunk], head,
                                   labels[:, c:c + chunk],
                                   use_reentrant=False)
    return total / (b * s)


def loss_fn(model, cfg: ArchConfig, inputs, labels, remat: bool = True):
    """(loss + AUX_LOSS_WEIGHT * aux, {"loss", "aux"}); ``inputs`` and
    ``labels`` on the model's device."""
    b, s = labels.shape
    positions = make_positions(cfg, b, s, labels.device)
    hidden, _, aux = model(inputs, positions, remat=remat,
                           return_hidden=True)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    loss = chunked_xent(hidden, head, labels)
    return loss + AUX_LOSS_WEIGHT * aux, {"loss": loss.detach(),
                                          "aux": aux.detach()}


def _grads(model, total) -> dict[str, torch.Tensor]:
    """d total / d every parameter; zeros for one the loss does not reach
    (the embedding table of a stub-frontend arch with an untied head).  A
    DTensor parameter's gradient comes in the parameter's placements (the
    partial sums of a sharded backward reduced)."""
    names, params = zip(*model.named_parameters())
    gs = torch.autograd.grad(total, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else _placed_like(g, p)
            for n, p, g in zip(names, params, gs)}


def _placed_like(g, p):
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _full(t):
    """A metric as a plain tensor (a DTensor's whole value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def train_step(model, opt_state: AdamWState, batch, *, cfg: ArchConfig,
               opt_cfg: AdamWConfig, microbatches: int = 1,
               remat: bool = True, device="cuda"):
    """One step on ``batch`` = {"inputs": (B, S) ints or (B, S, d),
    "labels": (B, S) ints} (tensors or numpy arrays, moved to ``device``).
    Updates ``model`` in place; returns (new opt state, metrics: "loss",
    "aux", "grad_norm", "lr" as 0-d tensors on the device)."""
    dev = resolve_device(device, meta=True)
    if model.embed.device != dev:
        raise ValueError(f"model lives on {model.embed.device}, not on {dev}")
    inputs = torch.as_tensor(batch["inputs"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev).long()

    if microbatches == 1:
        total, metrics = loss_fn(model, cfg, inputs, labels, remat)
        grads = _grads(model, total)
    else:
        mb = labels.shape[0] // microbatches
        g_sum = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in model.named_parameters()}
        l_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(microbatches):
            sl = slice(i * mb, (i + 1) * mb)
            total, m = loss_fn(model, cfg, inputs[sl], labels[sl], remat)
            for n, g in _grads(model, total).items():
                g_sum[n] += g.float()
            l_sum = l_sum + m["loss"]
        grads = {n: g / microbatches for n, g in g_sum.items()}
        metrics = {"loss": l_sum / microbatches,
                   "aux": torch.zeros((), dtype=torch.float32, device=dev)}

    opt_state, opt_metrics = adamw_update(opt_cfg, model, grads, opt_state)
    metrics.update(opt_metrics)
    return opt_state, {k: _full(v) for k, v in metrics.items()}
