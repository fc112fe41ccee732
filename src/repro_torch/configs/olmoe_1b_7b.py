"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    n_experts=64, moe_top_k=8, rope_theta=1e4, norm="rmsnorm", act="silu")

SMOKE_CONFIG = ArchConfig(
    name="olmoe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=32, vocab=256,
    n_experts=8, moe_top_k=2, capacity_factor=0.0, norm="rmsnorm", act="silu")
