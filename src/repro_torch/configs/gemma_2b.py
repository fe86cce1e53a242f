"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1).

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000 [arXiv:2403.08295; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16_384,
    vocab_size=256_000,
    head_dim=256,
    mlp_act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    remat="block",
)
