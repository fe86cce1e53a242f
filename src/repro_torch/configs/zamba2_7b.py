"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified].  One SHARED (attention + MLP) block applied
every 6 Mamba2 layers (13 applications + 3 tail mamba layers).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    tie_embeddings=True,
    remat="block",
)
