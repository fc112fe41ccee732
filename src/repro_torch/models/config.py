"""Unified architecture configuration for the assigned model pool (the
port's copy of ``repro.models.config``, kept identical)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads

    # attention flavour
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: Optional[int] = None   # sliding/local window; None = full
    m_rope: bool = False                # Qwen2-VL multimodal RoPE
    pos_emb: str = "rope"               # rope | none (frontend supplies)

    # layer pattern for hybrid stacks; scanned over `pattern repeats`
    block_pattern: tuple = ("attn",)    # e.g. ("rec","rec","attn")

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # recurrent / ssm
    rnn_width: int = 0                  # RG-LRU lru width
    ssm_state: int = 0                  # Mamba2 N
    ssm_head_dim: int = 64              # Mamba2 P
    ssm_chunk: int = 256                # SSD chunk length
    conv_width: int = 4

    # distribution knobs
    seq_parallel: bool = True           # Megatron-SP residual stream
    remat_group: int = 1                # superblocks per outer remat group

    # misc
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"                   # silu (swiglu) | gelu (plain mlp)
    frontend: Optional[str] = None      # vision | audio (stubbed)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.block_pattern):
            raise ValueError("n_layers must divide by pattern length; pad the "
                             "pattern or adjust the tail in the stack module")

    @property
    def pattern_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def takes_embeddings(self) -> bool:
        """VLM/audio backbones consume precomputed frontend embeddings."""
        return self.frontend is not None

    # ------------------------------------------------------------------
    # analytic parameter / FLOP model (used for roofline MODEL_FLOPS)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv, hd, ff = (self.d_model, self.n_heads, self.n_kv_heads,
                            self.head_dim, self.d_ff)
        per_layer = {}
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d   # q,k,v,o
        if self.qkv_bias:
            attn += (h + 2 * kv) * hd
        if self.act == "silu":
            mlp = 3 * d * ff                               # gate, up, down
        else:
            mlp = 2 * d * ff
        per_layer["attn"] = attn + 2 * d                   # + 2 norms
        if self.n_experts:
            experts = self.n_experts if not active_only else self.moe_top_k
            per_layer["attn"] += d * self.n_experts        # router
            per_layer["attn"] += experts * mlp - mlp       # replace dense mlp
        per_layer["attn"] += mlp
        # recurrent block (RG-LRU): in/out proj + conv + gates
        rw = self.rnn_width or d
        per_layer["rec"] = (2 * d * rw + rw * d + self.conv_width * rw
                            + 2 * rw * rw + 2 * d) + mlp + 2 * d
        # mamba2 block
        d_in = 2 * d
        nheads = d_in // self.ssm_head_dim if self.ssm_state else 0
        conv_dim = d_in + 2 * self.ssm_state
        per_layer["ssm"] = (d * (2 * d_in + 2 * self.ssm_state + nheads)
                            + conv_dim * self.conv_width + d_in * d
                            + d_in + 2 * nheads + 2 * d)
        total = 0
        for i in range(self.n_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            total += per_layer[kind]
        emb = self.vocab * d
        total += emb + d                                   # + final norm
        if not self.tie_embeddings:
            total += self.vocab * d                        # lm head
        return total

    def model_flops(self, batch: int, seq: int, decode: bool = False) -> float:
        """6*N*D (dense) / 6*N_active*D (MoE) training FLOPs, or 2*N per
        decoded token for serve steps."""
        n_active = self.param_count(active_only=True)
        tokens = batch * (1 if decode else seq)
        return (2.0 if decode else 6.0) * n_active * tokens
