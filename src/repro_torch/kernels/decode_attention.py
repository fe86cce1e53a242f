"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

Port of the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention``.  For a CUDA tensor the wrapper checks its inputs,
allocates the output and the split scratch, launches the hand-written kernel
(a split pass and a combine pass) on the current stream and counts one
launch; for a CPU tensor it runs the plain version
``ref.decode_attention_ref``.  There is no fallback: a CUDA input either
launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref
from .flash_attention import check_attention, check_vector_rows

#: launches of the kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"decode_attention": 0}

SPLIT_ALIGN = 64        # slots per shared-memory tile of the kernel
TARGET_BLOCKS = 264     # two blocks for each of the H100's 132 SMs


def split_plan(batch: int, n_kv: int, slots: int):
    """(n_split, chunk): enough splits of the slot axis that batch * n_kv *
    n_split blocks fill the card, each a whole number of tiles."""
    want = max(1, -(-TARGET_BLOCKS // max(batch * n_kv, 1)))
    chunk = -(-max(slots, 1) // want)
    chunk = -(-chunk // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-max(slots, 1) // chunk), chunk


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query per row against a (ring) cache: q (B, H, D), k/v (B, T,
    KV, D), kv_len (B,) valid slots per row -> (B, H, D) in q's dtype, fp32
    inside.  The cache may be in another dtype than q."""
    check_attention(q, k, v, 3)
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError(f"kv_len must be ({B},) on {q.device}")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_len, scale=scale, softcap=softcap)
    if D % 8:
        raise ValueError(f"head width {D} is not a multiple of 8")
    if q.stride(-1) != 1:
        raise ValueError("q's last axis must be contiguous")
    check_vector_rows("k", k)
    check_vector_rows("v", v)
    kv_len = kv_len.to(torch.int32).contiguous()
    n_split, chunk = split_plan(B, KV, T)
    G = H // KV
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    m_scr = torch.empty((B, KV, n_split, G), dtype=torch.float32, device=q.device)
    l_scr = torch.empty_like(m_scr)
    acc_scr = torch.empty((B, KV, n_split, G, D), dtype=torch.float32, device=q.device)
    lib = build.load("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            m_scr.data_ptr(), l_scr.data_ptr(), acc_scr.data_ptr(), B, T, H, KV, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), n_split, chunk,
            -1.0 if softcap is None else float(softcap), scale,
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), stream),
            "decode_attention_launch")
    LAUNCHES["decode_attention"] += 1
    return out
