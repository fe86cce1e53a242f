"""qwen3-1.7b [dense] — qk-norm, GQA, tied embeddings.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936 [hf:Qwen/Qwen3; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    remat="block",
)
