"""Qwen2-VL-72B backbone — M-RoPE, dynamic-resolution vision frontend is a
STUB (input_specs feeds precomputed patch embeddings) [arXiv:2409.12191]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
    head_dim=128, m_rope=True, qkv_bias=True, rope_theta=1e6,
    frontend="vision", norm="rmsnorm", act="silu", remat_group=8)

SMOKE_CONFIG = ArchConfig(
    name="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    m_rope=True, qkv_bias=True, frontend="vision",
    norm="rmsnorm", act="silu")
