"""Blocked (flash-style) attention: the reference's ``attn_impl="blocked"``.

Port of ``repro/models/blocked_attention.py``.  The reference expresses
the online softmax over streamed KV blocks in pure XLA (``lax.scan``), so
that GSPMD can partition it, and skips whole KV blocks outside the causal
or sliding-window range.  That is the Pallas kernel's contract, and the
port's K6 (``kernels/flash_attention.py``) keeps it on the card: it streams
key tiles through an online softmax, skips the tiles outside a block's
range, and takes ``q_offset``, the absolute position of q[0] (a chunk of
a longer prompt), so this function calls ``ops.flash_attention``.

``block_q`` and ``block_k`` are accepted for the reference's signature:
they set the reference's XLA tiling and not K6's tiles, which its launch
plan takes from the dtype and head width.  Under a mesh, the call takes
DTensors like every K6 call (``ops.flash_attention``): each rank runs K6
on its batch and head shards.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops


def blocked_attention(
    q: torch.Tensor,               # (B, S, H, D)
    k: torch.Tensor,               # (B, T, KV, D)
    v: torch.Tensor,               # (B, T, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    block_q: int = 2048,
    block_k: int = 1024,
    q_offset: int = 0,             # absolute position of q[0] (cross-chunk)
) -> torch.Tensor:
    """GQA attention of q against k, v in q's dtype (fp32 inside): row s is
    position s + ``q_offset`` and sees key t where ``t <= s + q_offset``
    (causal) and ``t > s + q_offset - window`` (window); a row that sees no
    key gives 0."""
    del block_q, block_k   # the reference's XLA tiling (see the module docstring)
    return ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               scale=scale, q_offset=q_offset)
