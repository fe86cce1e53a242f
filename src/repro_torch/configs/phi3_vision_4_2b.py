"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub.

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf].  The CLIP image encoder is a
STUB: input_specs provides patch embeddings prepended to the text sequence.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    head_dim=96,
    rope_theta=10_000.0,
    frontend="vision",
    n_frontend_tokens=576,
    remat="block",
)
