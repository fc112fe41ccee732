"""Generic decoder stack covering all 10 assigned architectures (port of
``repro.models.transformer``).

The stack is ``cfg.block_pattern`` repeated ``cfg.pattern_repeats`` times,
one ``nn.Module`` per block, kept in layer order: layer
``r * len(pattern) + i`` is repeat ``r``, pattern slot ``i``.  Block
parameters carry the reference's names (``blocks.<layer>.wq``, ...).

Caches (decode) are a list with one dict per layer:

- attention: ``k``, ``v`` (B, cap, KV, hd) and ``pos`` (B, cap) int32,
  the absolute position in each slot (-1 when empty); ``cap`` is the
  window for windowed layers (a ring: position p lives in slot p % cap);
- recurrent: ``h`` (B, rw) f32 and ``conv`` (B, cw-1, rw);
- ssm: ``state`` (B, H, P, N) and ``conv`` (B, cw-1, d_in + 2N).

A decode step writes the attention caches in place and returns the cache
to use next.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..dist.constraints import BATCH, constrain, divides
from ..kernels.config import resolve_device
from .config import ArchConfig
from .layers import (META_INIT, MLP, Norm, apply_rope, decode_attention,
                     dense_init, flash_attention, pad_seq, rmsnorm)
from .mamba2 import Mamba2, mamba2_apply
from .moe import MoE, load_balancing_loss, moe_apply
from .moe_shardmap import moe_apply_shardmap
from .rglru import RGLRU, rglru_apply

MROPE_SECTIONS = (16, 24, 24)   # Qwen2-VL mrope_section over head_dim/2


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _zeros(n: int, gen, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, device=gen.device, dtype=dtype))


def _aux0(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


class AttnBlock(nn.Module):
    """Attention (GQA, optional qkv bias / qk-norm / window / M-RoPE) and
    an MLP or MoE, each behind a pre-norm."""

    def __init__(self, cfg: ArchConfig, gen, dtype):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        norm = dict(device=gen.device, dtype=dtype)
        self.ln1 = Norm(d, cfg.norm, cfg.norm_eps, **norm)
        self.wq = dense_init(gen, (d, h * hd), dtype)
        self.wk = dense_init(gen, (d, kv * hd), dtype)
        self.wv = dense_init(gen, (d, kv * hd), dtype)
        self.wo = dense_init(gen, (h * hd, d), dtype)
        self.ln2 = Norm(d, cfg.norm, cfg.norm_eps, **norm)
        if cfg.qkv_bias:
            self.bq = _zeros(h * hd, gen, dtype)
            self.bk = _zeros(kv * hd, gen, dtype)
            self.bv = _zeros(kv * hd, gen, dtype)
        if cfg.qk_norm:
            self.q_norm = _zeros(hd, gen, dtype)
            self.k_norm = _zeros(hd, gen, dtype)
        if cfg.n_experts:
            self.moe = MoE(gen, d, cfg.d_ff, cfg.n_experts, cfg.act, dtype)
        else:
            self.mlp = MLP(gen, d, cfg.d_ff, cfg.act, dtype)

    def _project_qkv(self, h):
        cfg = self.cfg
        b, s, _ = h.shape
        # a DTensor reshape splits a sharded dim only into whole shards, so
        # the flat projections are placed before the head split (the
        # reference places the split q / k / v), and before the bias too,
        # so that no partial sum meets it
        heads = q_heads_entry(cfg)

        def place(t, entry):
            return constrain(t, BATCH, None, entry)
        q, k, v = (place(h @ self.wq, heads), place(h @ self.wk, None),
                   place(h @ self.wv, None))
        if cfg.qkv_bias:
            q, k, v = (place(q + self.bq, heads), place(k + self.bk, None),
                       place(v + self.bv, None))
        q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        return q, k, v

    def forward(self, x, positions, cache, cur_pos, build_len=None):
        """cache None: training / prefill; else one decode token."""
        cfg = self.cfg
        # Megatron-SP transition: all-gather the sequence dim here; heads are
        # model-sharded inside attention; the residual add reduce-scatters
        h = constrain(self.ln1(x), BATCH, None, None)
        q, k, v = self._project_qkv(h)
        # tensor-parallel attention: q heads over `model`, the small GQA
        # k / v replicated (q_heads_entry: where whole KV groups fit)
        q = constrain(q, BATCH, None, q_heads_entry(cfg), None)
        k = constrain(k, BATCH, None, None, None)
        v = constrain(v, BATCH, None, None, None)
        if cfg.pos_emb == "rope":
            sections = MROPE_SECTIONS if cfg.m_rope else None
            q = apply_rope(q, positions, cfg.rope_theta, sections)
            k = apply_rope(k, positions, cfg.rope_theta, sections)
        aux = _aux0(x)
        if cache is None:
            pos1d = (positions[0] if positions.ndim == 3 else positions)[0]
            attn = flash_attention(q, k, v, pos1d, pos1d,
                                   window=cfg.attn_window)
            new_cache = (None if build_len is None
                         else _prefill_cache(cfg, k, v, pos1d, build_len))
        else:
            kc, vc, pc = cache["k"], cache["v"], cache["pos"]
            slot = cur_pos % kc.shape[1]
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
            pc[:, slot] = torch.full_like(pc[:, slot], cur_pos)
            qpos = torch.full_like(pc[:, 0], cur_pos)  # as pc, by batch
            attn = decode_attention(q, kc, vc, qpos, pc,
                                    window=cfg.attn_window)
            new_cache = {"k": kc, "v": vc, "pos": pc}
        # the gradient placed by heads before the backward splits them
        attn = constrain(attn.reshape(*attn.shape[:2], -1), BATCH, None,
                         q_heads_entry(cfg))
        # a cache of another dtype than the weights (f32 weights over a
        # bf16 cache) promotes as jnp does
        dt = torch.promote_types(attn.dtype, self.wo.dtype)
        x = _residual(cfg, x, attn.to(dt) @ self.wo.to(dt))

        h2 = constrain(self.ln2(x), BATCH, None, None)   # SP (MLP side)
        if cfg.n_experts:
            # decode never drops tokens (exact capacity); prefill and
            # training use the configured capacity factor
            cf = 0.0 if cache is not None else cfg.capacity_factor
            moe = dict(top_k=cfg.moe_top_k, capacity_factor=cf, act=cfg.act)
            res = None
            if cache is None:
                # the explicit dispatch (moe_shardmap.py): engages only
                # under an active mesh with a `model` axis
                res = moe_apply_shardmap(self.moe, h2, **moe)
            if res is None:
                res = moe_apply(self.moe, h2, **moe)
            y, router_logits = res
            aux = load_balancing_loss(router_logits)
        else:
            y = self.mlp(h2)
        return _residual(cfg, x, y), new_cache, aux


def _lookup(table, idx):
    """``table[idx]``.  A DTensor table is gathered whole and indexed on
    each device's own rows of ``idx`` (``local_map``): the same arithmetic
    as one device's, forward and backward (DTensor's own rules fail here:
    a vocab-sharded lookup leaves a masked partial sum that is reduced
    wrongly on a batch-sharded mesh, and torch 2.11's rule for the
    indexing backward is wrong); the table's gradient is a partial sum
    over the axes that split ``idx``."""
    if not isinstance(table, DTensor):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rows = (tuple(idx.placements) if isinstance(idx, DTensor)
            else (Replicate(),) * mesh.ndim)
    whole = (Replicate(),) * mesh.ndim
    grad = tuple(Replicate() if r == Replicate() else Partial()
                 for r in rows)
    return local_map(lambda t, i: t[i], out_placements=(rows,),
                     in_placements=(whole, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(
                         constrain(table, None, None), idx)


def _residual(cfg: ArchConfig, x, y):
    """``x + y``, the branch output ``y`` first placed as the residual
    stream (Megatron-SP: a partial sum reduce-scatters back to the
    sequence shards; a no-op without a mesh)."""
    sp = "model" if cfg.seq_parallel else None
    return x + constrain(y, BATCH, sp, None)


def q_heads_entry(cfg: ArchConfig):
    """The mesh entry of q's head axis: `model` where it divides the KV
    heads, so each device holds whole GQA groups (attention splits H into
    (KV, G) next, and a DTensor cannot split a shard); else None, and
    ``flash_attention`` puts `model` on G.  The reference shards H wherever
    `model` divides it."""
    return "model" if divides("model", cfg.n_kv_heads) else None


def _prefill_cache(cfg, k, v, pos1d, build_len):
    """Token-parallel cache construction (prefill): the prompt's K/V in a
    fresh cache -- for a windowed layer the last ``cap`` tokens, position p
    in slot p % cap."""
    b, s = k.shape[:2]
    cap = min(build_len, cfg.attn_window) if cfg.attn_window else build_len
    if s >= cap:
        start = s - cap
        j = torch.arange(cap, device=k.device)
        src = start + (j - start) % cap           # position living in slot j
        pc = pos1d[src][None].expand(b, cap).to(torch.int32)
        return {"k": k[:, src], "v": v[:, src], "pos": pc.contiguous()}
    kc, vc = pad_seq(k, 0, cap - s), pad_seq(v, 0, cap - s)
    pc = torch.full((b, cap), -1, dtype=torch.int32, device=k.device)
    pc[:, :s] = pos1d.to(torch.int32)
    return {"k": kc, "v": vc, "pos": pc}


class RecBlock(nn.Module):
    """RG-LRU recurrence and an MLP, each behind a pre-norm."""

    def __init__(self, cfg: ArchConfig, gen, dtype):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        norm = dict(device=gen.device, dtype=dtype)
        self.ln1 = Norm(d, cfg.norm, cfg.norm_eps, **norm)
        self.lru = RGLRU(gen, d, cfg.rnn_width or d, cfg.conv_width, dtype)
        self.ln2 = Norm(d, cfg.norm, cfg.norm_eps, **norm)
        self.mlp = MLP(gen, d, cfg.d_ff, cfg.act, dtype)

    def forward(self, x, positions, cache, cur_pos, build_len=None):
        h0 = cache["h"] if cache is not None else None
        cs = cache["conv"] if cache is not None else None
        h = constrain(self.ln1(x), BATCH, None, None)   # SP (recurrence)
        y, (h_new, cs_new) = rglru_apply(self.lru, h, h0, cs)
        x = _residual(self.cfg, x, y)
        x = _residual(self.cfg, x, self.mlp(constrain(self.ln2(x), BATCH,
                                                      None, None)))
        new_cache = ({"h": h_new, "conv": cs_new}
                     if (cache is not None or build_len is not None)
                     else None)
        return x, new_cache, _aux0(x)


class SSMBlock(nn.Module):
    """Mamba2 behind a pre-norm."""

    def __init__(self, cfg: ArchConfig, gen, dtype):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps,
                        device=gen.device, dtype=dtype)
        self.ssm = Mamba2(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                          cfg.conv_width, dtype)

    def forward(self, x, positions, cache, cur_pos, build_len=None):
        cfg = self.cfg
        st = cache["state"] if cache is not None else None
        cs = cache["conv"] if cache is not None else None
        y, (st_new, cs_new) = mamba2_apply(
            self.ssm, constrain(self.ln1(x), BATCH, None, None), st, cs,
            d_model=cfg.d_model,
            ssm_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            chunk=cfg.ssm_chunk)
        new_cache = ({"state": st_new, "conv": cs_new}
                     if (cache is not None or build_len is not None)
                     else None)
        return _residual(cfg, x, y), new_cache, _aux0(x)


_BLOCKS = {"attn": AttnBlock, "rec": RecBlock, "ssm": SSMBlock}


class Model(nn.Module):
    """Embedding, the blocks in layer order, a final norm and the LM head
    (the embedding's transpose when tied)."""

    def __init__(self, cfg: ArchConfig, gen, dtype):
        super().__init__()
        self.cfg = cfg
        self.embed = dense_init(gen, (cfg.vocab, cfg.d_model), dtype,
                                scale=0.02)
        self.blocks = nn.ModuleList(
            _BLOCKS[layer_kind(cfg, i)](cfg, gen, dtype)
            for i in range(cfg.n_layers))
        self.ln_f = Norm(cfg.d_model, cfg.norm, cfg.norm_eps,
                         device=gen.device, dtype=dtype)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(gen, (cfg.d_model, cfg.vocab), dtype)

    def forward(self, inputs, positions, cache=None, cur_pos=None,
                build_cache_len=None, remat: bool = True,
                return_hidden: bool = False):
        cfg = self.cfg
        if cfg.takes_embeddings and inputs.ndim == 3:
            x = inputs
        else:
            x = _lookup(self.embed, inputs)
        sp = "model" if cfg.seq_parallel else None
        n_slots = len(cfg.block_pattern)

        def superblock(x, r):
            """Repeat ``r`` of the pattern: (x, its caches, its aux summed
            from its first block's, as the reference sums it from 0)."""
            caches, aux = [], None
            for layer in range(r * n_slots, (r + 1) * n_slots):
                # sequence-parallel residual stream (Megatron-SP), dropped
                # at S == 1 (decode) or where `model` does not divide S
                x = constrain(x, BATCH, sp, None)
                x, nc, a = self.blocks[layer](
                    x, positions, None if cache is None else cache[layer],
                    cur_pos, build_len=build_cache_len)
                caches.append(nc)
                aux = a if aux is None else aux + a
            return x, caches, aux

        new_cache = []
        aux = _aux0(x)
        if remat and cache is None and build_cache_len is None \
                and torch.is_grad_enabled():
            x, aux = self._remat_stack(superblock, x, aux)
        else:
            for r in range(cfg.pattern_repeats):
                x, nc, a = superblock(x, r)
                new_cache += nc
                aux = aux + a
        # the sequence gathered for the head (a sharded matmul cannot
        # flatten a sequence sharded after the batch)
        x = constrain(self.ln_f(x), BATCH, None, None)
        returns_cache = cache is not None or build_cache_len is not None
        new_cache = new_cache if returns_cache else None
        if return_hidden:
            return x, new_cache, aux
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return x @ head, new_cache, aux

    def _remat_stack(self, superblock, x, aux):
        """The repeats with each superblock under ``checkpoint`` (only its
        input is kept; the backward recomputes its inside), and with
        ``remat_group = g > 1`` dividing the repeats, each group of g
        superblocks under a second, outer checkpoint: live residuals
        O(repeats / g + g) at the cost of one more forward per group."""
        cfg = self.cfg

        def one(x, r):
            x, _, a = superblock(x, r)
            return x, a

        def ckpt(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False)

        def run(x, aux, reps):
            for r in reps:
                x, a = ckpt(one, x, r)
                aux = aux + a
            return x, aux

        g = cfg.remat_group
        if g > 1 and cfg.pattern_repeats % g == 0:
            for start in range(0, cfg.pattern_repeats, g):
                x, aux = ckpt(run, x, aux, range(start, start + g))
            return x, aux
        return run(x, aux, range(cfg.pattern_repeats))


def layer_kind(cfg: ArchConfig, layer: int) -> str:
    """The block kind of ``layer`` (its pattern slot)."""
    return cfg.block_pattern[layer % len(cfg.block_pattern)]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int, *, device="cuda",
                dtype=torch.bfloat16) -> Model:
    """The model with weights drawn from ``torch.Generator(device)`` seeded
    with ``seed`` (the weights depend on the seed and the device type)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Model(cfg, gen, dtype)


def param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> Model:
    """The model on the meta device: every parameter's shape and dtype, no
    allocation and no draw (the reference's ``jax.eval_shape`` of
    ``init_params``)."""
    return Model(cfg, META_INIT, dtype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda",
               dtype=torch.bfloat16) -> list[dict]:
    """An empty decode cache: one dict per layer (module docstring)."""
    dev = resolve_device(device, meta=True)
    rw = cfg.rnn_width or cfg.d_model
    d_in = 2 * cfg.d_model
    conv_dim = d_in + 2 * cfg.ssm_state
    caches = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        if kind == "attn":
            cap = min(max_len, cfg.attn_window) if cfg.attn_window \
                else max_len
            shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
            c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev),
                 "pos": torch.full((batch, cap), -1, dtype=torch.int32,
                                   device=dev)}
        elif kind == "rec":
            c = {"h": torch.zeros((batch, rw), dtype=torch.float32,
                                  device=dev),
                 "conv": torch.zeros((batch, cfg.conv_width - 1, rw),
                                     dtype=dtype, device=dev)}
        else:
            nheads = d_in // cfg.ssm_head_dim
            c = {"state": torch.zeros((batch, nheads, cfg.ssm_head_dim,
                                       cfg.ssm_state), dtype=torch.float32,
                                      device=dev),
                 "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                                     dtype=dtype, device=dev)}
        caches.append(c)
    return caches


def forward(params: Model, cfg: ArchConfig, inputs, positions, cache=None,
            cur_pos: int | None = None, build_cache_len: int | None = None,
            *, remat: bool = True, return_hidden: bool = False,
            device="cuda"):
    """inputs: (B, S) int tokens, or (B, S, d) embeddings for frontend archs;
    positions: (B, S), or (3, B, S) for M-RoPE.

    ``cache`` with ``cur_pos`` (an int): one decode token, the cache's
    attention tensors written in place.  ``build_cache_len``: token-parallel
    prefill, building a decode-ready cache of that capacity.
    ``remat``: under autograd, with no cache, checkpoint each superblock
    (one repeat of ``block_pattern``) and, where ``cfg.remat_group`` divides
    the repeats, each group of them (``Model._remat_stack``).
    ``return_hidden``: skip the LM head and return the final hidden states
    (the training loss fuses the head with a chunked cross entropy).
    ``params`` must live on ``device``; ``inputs`` and ``positions`` are
    moved there.  Returns (logits_or_hidden, new_cache, aux_loss).
    """
    dev = resolve_device(device, meta=True)
    if cfg != params.cfg:
        raise ValueError(f"params were built for {params.cfg.name}, not "
                         f"{cfg.name}")
    if params.embed.device != dev:
        raise ValueError(f"params live on {params.embed.device}, not on "
                         f"{dev}")
    inputs = torch.as_tensor(inputs, device=dev)
    positions = torch.as_tensor(positions, device=dev)
    return params(inputs, positions, cache=cache, cur_pos=cur_pos,
                  build_cache_len=build_cache_len, remat=remat,
                  return_hidden=return_hidden)
