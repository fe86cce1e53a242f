"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  d_ff=1408 is the per-expert (moe) ffn dim;
four shared experts run on every token; top-4 routed gates renormalised.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    capacity_factor=1.25,
    renorm_topk=True,
    remat="block",
)
