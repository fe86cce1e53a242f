"""llama4-maverick-400b-a17b [moe] — MoE, early fusion VLM.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Llama4's MoE couples the
top-1 routed expert with an always-on shared expert; the vision frontend is
an early-fusion stub (patch embeddings provided by input_specs).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    capacity_factor=1.25,
    frontend="vision",
    n_frontend_tokens=1024,
    remat="block",
)
