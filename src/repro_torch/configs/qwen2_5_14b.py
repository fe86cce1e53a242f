"""qwen2.5-14b [dense] — GQA with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 [hf:Qwen/Qwen2.5; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13_824,
    vocab_size=152_064,
    head_dim=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    remat="block",
)
