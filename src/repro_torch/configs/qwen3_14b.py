"""Qwen3-14B — dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-14B]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=17408, vocab=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6, norm="rmsnorm", act="silu")

SMOKE_CONFIG = ArchConfig(
    name="qwen3-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    qk_norm=True, norm="rmsnorm", act="silu")
