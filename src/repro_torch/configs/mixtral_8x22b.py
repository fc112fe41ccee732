"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
    n_experts=8, moe_top_k=2, attn_window=4096, rope_theta=1e6,
    norm="rmsnorm", act="silu", remat_group=7)

SMOKE_CONFIG = ArchConfig(
    name="mixtral-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    n_experts=4, moe_top_k=2, capacity_factor=0.0, attn_window=16, norm="rmsnorm", act="silu")
