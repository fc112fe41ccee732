"""Mamba2-130M — attention-free SSD (state-space duality)
[arXiv:2405.21060].  d_inner = 2*d_model, 24 heads of P=64, N=128."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=0, vocab=50280,
    block_pattern=("ssm",), ssm_state=128, ssm_head_dim=64, ssm_chunk=256,
    norm="rmsnorm", act="silu", tie_embeddings=True)

SMOKE_CONFIG = ArchConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=0, vocab=256,
    block_pattern=("ssm",), ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
    norm="rmsnorm", act="silu", tie_embeddings=True)
