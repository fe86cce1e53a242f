"""gemma2-9b [dense] — local/global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 [arXiv:2408.00118].
Sliding window 4096 on local layers, attn softcap 50, final softcap 30,
query_pre_attn_scalar=256, GeGLU, post-norms, embeddings scaled by sqrt(d).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=256_000,
    head_dim=256,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=256.0,
    use_post_norms=True,
    mlp_act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    remat="block",
)
