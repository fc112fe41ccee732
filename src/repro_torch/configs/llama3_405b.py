"""Llama-3.1-405B — dense, GQA kv=8, 128k vocab [arXiv:2407.21783]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
    head_dim=128, rope_theta=5e5, norm="rmsnorm", act="silu",
    seq_parallel=False, remat_group=9)

SMOKE_CONFIG = ArchConfig(
    name="llama3-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    norm="rmsnorm", act="silu")
