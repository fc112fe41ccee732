"""MusicGen-medium backbone — decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB (input_specs feeds precomputed frame embeddings)
[arXiv:2306.05284].  MHA (kv=24), LayerNorm, GELU, positions supplied by the
frontend (sinusoidal) so pos_emb="none"."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048,
    pos_emb="none", frontend="audio", norm="layernorm", act="gelu")

SMOKE_CONFIG = ArchConfig(
    name="musicgen-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
    pos_emb="none", frontend="audio", norm="layernorm", act="gelu")
