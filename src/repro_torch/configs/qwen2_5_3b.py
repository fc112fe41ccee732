"""Qwen2.5-3B — dense, GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-3B]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936,
    qkv_bias=True, rope_theta=1e6, norm="rmsnorm", act="silu")

SMOKE_CONFIG = ArchConfig(
    name="qwen2.5-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    qkv_bias=True, norm="rmsnorm", act="silu")
