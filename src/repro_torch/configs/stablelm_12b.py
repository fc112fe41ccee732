"""StableLM-2-12B — dense, GQA kv=8, LayerNorm
[hf:stabilityai/stablelm-2-12b]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352,
    rope_theta=1e4, norm="layernorm", act="silu")

SMOKE_CONFIG = ArchConfig(
    name="stablelm-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    norm="layernorm", act="silu")
