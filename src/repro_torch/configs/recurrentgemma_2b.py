"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 1:2 ratio
[arXiv:2402.19427].  26 layers = 2 repeats of a 13-block pattern with
attention at every third slot (8 attn + 18 recurrent, matching the
published stack)."""
from ..models.config import ArchConfig

_PATTERN = ("rec", "rec", "attn") * 4 + ("rec",)   # x2 repeats = 26 layers

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000,
    block_pattern=_PATTERN, rnn_width=2560, attn_window=2048,
    head_dim=256, rope_theta=1e4, norm="rmsnorm", act="gelu",
    tie_embeddings=True)

SMOKE_CONFIG = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=6, d_model=64,
    n_heads=2, n_kv_heads=1, d_ff=128, vocab=256,
    block_pattern=("rec", "rec", "attn"), rnn_width=64, attn_window=16,
    head_dim=32, norm="rmsnorm", act="gelu")
