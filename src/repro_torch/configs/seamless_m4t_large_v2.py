"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

24 encoder + 24 decoder layers, d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 [arXiv:2308.11596; hf].  The speech frontend is a STUB:
input_specs provides precomputed frame embeddings (DESIGN.md §2).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=48,            # 24 enc + 24 dec
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    head_dim=64,
    frontend="audio",
    tie_embeddings=True,
    remat="block",
)
