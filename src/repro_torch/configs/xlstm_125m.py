"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.

12L d_model=768 4H vocab=50304 [arXiv:2405.04517; unverified].  Every 4th
block is sLSTM (scalar memory, sequential), the rest mLSTM (matrix memory,
parallelisable).  d_ff=0: xLSTM blocks integrate their MLPs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=4,
    tie_embeddings=True,
)
