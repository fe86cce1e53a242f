"""The yardstick's arithmetic: an H100's peaks, the least time a kernel call
needs, and the FLOPs of a dense decoder's prefill, all counted from shapes.

The bound functions follow ``chip_smoke.py``'s (``bound``, ``probed_bound``
and the count in ``flash_row``), copied here so that the benchmark keeps its
own: a later change to the smoke script cannot move a roofline share.  A
bound counts what the inputs need (each input byte read once, each output
byte written once, the operations of distinct work), so a share of it can
never pass 100 % unless the time leaves out part of the work.
"""
from __future__ import annotations

from typing import Mapping, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # CUDA cores
BF16_FLOP_PER_S = 989e12       # tensor cores, dense


def bound_s(n_bytes: float, n_flop: float, flop_per_s: float) -> Tuple[float, str]:
    """(least seconds on an H100, "bytes" or "operations": what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / flop_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- K6
def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask keeps in one sequence of ``s``."""
    return s * (s + 1) // 2


def k6_bound_s(b: int, s: int, h: int, kv: int, d: int, elem_bytes: int = 2) -> float:
    """K6 ``flash_attention``, causal, no window: 4·D FLOP a visible pair and
    head (QK^T and PV) at the bf16 tensor-core peak; q and out (B, S, H, D)
    and k, v (B, S, KV, D) each moved once."""
    flop = 4.0 * b * h * d * causal_pairs(s)
    n_bytes = elem_bytes * (2 * b * s * h * d + 2 * b * s * kv * d)
    return bound_s(n_bytes, flop, BF16_FLOP_PER_S)[0]


# ----------------------------------------------------------------- K1
def k1_bound_s(b: int, d: int, t: int, p: int, n_pairs: int, n_slot_rows: int = 0,
               cap: int = 0, n_rows: int = 0) -> float:
    """K1 ``reuse_top1_probed`` over B queries: 2·D FLOP a distinct valid
    (query, candidate) pair at the fp32 CUDA-core peak; q (B, D) f32, the
    (B, T, P) int32 probe buckets, each distinct probed slot row (``cap``
    int32 ids) and each distinct store row (D f32) read once, (score, id)
    written.  Where the distinct rows are not counted (0) the bytes are a
    lower bound, and so is the time."""
    n_bytes = 4 * b * d + 4 * b * t * p + 4 * n_slot_rows * cap + 4 * n_rows * d + 8 * b
    return bound_s(n_bytes, 2.0 * d * n_pairs, FP32_FLOP_PER_S)[0]


# ----------------------------------------------------------------- model
def dense_layer_params(m: Mapping[str, int]) -> int:
    """Weights one dense decoder layer multiplies by (q, k, v, o and the
    gated MLP), from a configuration's published sizes."""
    d, h, kv, hd, ff = (m["hidden_size"], m["num_attention_heads"],
                        m["num_key_value_heads"], m["head_dim"], m["intermediate_size"])
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff


def prefill_flop(m: Mapping[str, int], n: int, s: int) -> float:
    """Model FLOPs of one prefill of ``n`` prompts of ``s`` tokens that
    returns the last position's logits: 2 a weight and token in every
    layer, 4·D a visible causal pair and head in attention, and the
    vocabulary projection of the last position."""
    per_seq = (2.0 * s * m["num_hidden_layers"] * dense_layer_params(m)
               + 4.0 * m["num_hidden_layers"] * m["num_attention_heads"] * m["head_dim"]
               * causal_pairs(s)
               + 2.0 * m["hidden_size"] * m["vocab_size"])
    return n * per_seq
