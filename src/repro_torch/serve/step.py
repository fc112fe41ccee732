"""Serving steps: batched prefill and single-token decode (port of
``repro.serve.step``).

``prefill`` runs the whole prompt through the stack at once and builds a
decode-ready cache -- ring buffers of the window size for windowed layers,
carried states for recurrent layers; ``serve_step`` decodes one token
against it.  ``greedy_generate`` runs them as a plain Python loop.
"""
from __future__ import annotations

import torch

from ..kernels.config import resolve_device
from ..models import forward
from ..models.config import ArchConfig
from ..models.transformer import layer_kind

#: the cache entries ``prefill`` casts to ``cache_dtype``, per block kind:
#: the reference casts every float leaf of its stacked cache with ndim >= 4,
#: which leaves the RG-LRU state ``h`` (and the int32 ``pos``) as they are
_CAST = {"attn": ("k", "v"), "rec": ("conv",), "ssm": ("state", "conv")}


def _positions(cfg: ArchConfig, batch: int, start: int, length: int,
               device) -> torch.Tensor:
    p = torch.arange(start, start + length, device=device)[None] \
        .expand(batch, length)
    return p[None].expand(3, batch, length) if cfg.m_rope else p


@torch.no_grad()
def prefill(params, cfg: ArchConfig, inputs, *, max_len: int,
            cache_dtype=torch.bfloat16, device="cuda"):
    """Token-parallel prefill of ``inputs`` (B, S) tokens or (B, S, d)
    embeddings.  Returns (cache of capacity ``max_len``, logits (B, S,
    vocab))."""
    dev = resolve_device(device, meta=True)
    inputs = torch.as_tensor(inputs, device=dev)
    b, s = inputs.shape[:2]
    logits, cache, _ = forward(params, cfg, inputs,
                               _positions(cfg, b, 0, s, dev),
                               build_cache_len=max_len, device=dev)
    for i, c in enumerate(cache):
        for name in _CAST[layer_kind(cfg, i)]:
            c[name] = c[name].to(cache_dtype)
    return cache, logits


@torch.no_grad()
def serve_step(params, cache, tokens, cur_pos: int, *, cfg: ArchConfig,
               device="cuda"):
    """One decode step.  tokens: (B, 1) ints (or (B, 1, d) embeddings);
    cur_pos: the absolute position.  Writes ``cache`` in place; returns
    (logits (B, vocab), the cache to use next)."""
    dev = resolve_device(device, meta=True)
    tokens = torch.as_tensor(tokens, device=dev)
    cur_pos = int(cur_pos)
    logits, cache, _ = forward(params, cfg, tokens,
                               _positions(cfg, tokens.shape[0], cur_pos, 1,
                                          dev),
                               cache=cache, cur_pos=cur_pos, device=dev)
    return logits[:, 0], cache


@torch.no_grad()
def greedy_generate(params, cfg: ArchConfig, prompt, n_new: int, *,
                    max_len: int, cache_dtype=torch.bfloat16,
                    device="cuda") -> torch.Tensor:
    """Greedy decoding after a prefill of ``prompt`` (B, S): the argmax of
    the prompt's last logits is fed at position S, and each step's argmax
    is returned and fed to the next.  Returns (B, n_new) token ids."""
    cache, logits = prefill(params, cfg, prompt, max_len=max_len,
                            cache_dtype=cache_dtype, device=device)
    s = logits.shape[1]
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = []
    for t in range(s, s + n_new):
        lg, cache = serve_step(params, cache, tok, t, cfg=cfg, device=device)
        tok = torch.argmax(lg, dim=-1)[:, None]
        out.append(tok[:, 0])
    if not out:
        return torch.empty((tok.shape[0], 0), dtype=tok.dtype,
                           device=tok.device)
    return torch.stack(out, dim=1)
