"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

Port of the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention``.  For a CUDA tensor the wrapper checks its inputs,
allocates the output and the split scratch, launches the hand-written kernel
(a split pass and a combine pass) on the current stream and counts one
launch (the split plan is computed here, ``split_plan``, where the CPU
tests reach it); for a CPU tensor it runs the plain version
``ref.decode_attention_ref``.  There is no fallback: a CUDA input either
launches the kernel or raises.  ``return_lse`` adds each row's log-sum-exp
over its valid slots, which the combine pass writes (what merging the
outputs of several cache shards needs: ``ops.sharded_decode_attention``).
FakeTensors (a dry run) allocate what the kernel allocates (out, the split
scratch, lse), launch nothing, count no launch and record ``work``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref
from .flash_attention import check_attention, check_vector_rows

#: launches of the kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"decode_attention": 0}

TARGET_BLOCKS = 528     # four 4-warp blocks for each of the H100's 132 SMs
CHUNK_ALIGN = 16        # a row's split is a multiple of this many slots (kChunkAlign)
MAX_HEADS_PER_BLOCK = 8
MAX_D = 256             # 32 lanes x 2 pieces of 16 bytes a row in f32 (kMaxD)


def heads_per_block(G: int) -> int:
    """Query heads one block serves (1, 2, 4 or 8): the least power of two
    that holds G, at most 8; more heads take more blocks."""
    return next(n for n in (1, 2, 4, 8) if n >= min(G, MAX_HEADS_PER_BLOCK))


def split_plan(batch: int, n_kv: int, slots: int, G: int = 1, D: int = 128,
               cache_bytes: int = 2) -> dict:
    """The split kernel's launch shape.  ``n_split`` blocks per (row, kv
    head, head group): enough that the grid holds TARGET_BLOCKS, but no more
    than CHUNK_ALIGN-slot pieces of the cache.  Each row then cuts its own
    valid slots, min(kv_len, T), into ``row_chunk`` pieces on the card.  A
    cache row of D elements is read 16 bytes a lane by ``lanes`` lanes,
    ``pieces_per_lane`` pieces each."""
    hpb = heads_per_block(G)
    groups = batch * n_kv * -(-G // hpb)
    n_split = max(1, min(-(-TARGET_BLOCKS // max(groups, 1)),
                         -(-max(slots, 1) // CHUNK_ALIGN)))
    pieces = D * cache_bytes // 16
    lanes = min(32, 1 << max(0, (pieces - 1).bit_length()))
    return {"n_split": n_split, "heads_per_block": hpb, "head_groups": -(-G // hpb),
            "lanes": lanes, "lanes_log2": lanes.bit_length() - 1,
            "pieces_per_lane": -(-pieces // lanes),
            "grid": (n_split, n_kv * -(-G // hpb), batch)}


def row_chunk(length: int, n_split: int) -> int:
    """Slots per split of a row with ``length`` valid slots, as the kernel
    plans it: ceil(length / n_split) rounded up to CHUNK_ALIGN.  Split s
    covers [s * chunk, min((s + 1) * chunk, length)); the splits past the
    row's end read nothing."""
    c = -(-length // n_split)
    return max(CHUNK_ALIGN, -(-c // CHUNK_ALIGN) * CHUNK_ALIGN)


def work(B: int, H: int, KV: int, D: int, slots: int, q_elem: int, cache_elem: int,
         with_lse: bool = False) -> dict:
    """K7's work over rows whose valid slots number ``slots`` in all: 4 D
    FLOPs a (slot, head) (q.k and p.v), each valid slot's k and v read once,
    q read and out written once (``q_elem`` bytes an element), kv_len read
    (4 bytes a row) and lse written (4 bytes a row and head), an exp a
    (slot, head)."""
    return {"flops": 4.0 * H * D * slots,
            "bytes": q_elem * 2 * B * H * D + cache_elem * 2 * slots * KV * D + 4 * B
            + (4 * B * H if with_lse else 0),
            "transcendental": float(H * slots)}


def combine(out: torch.Tensor, lse: torch.Tensor, all_max, all_sum) -> torch.Tensor:
    """Merge the partial outputs of K7 over the shards of a cache (slots cut
    into shards, each shard run with ``return_lse``): ``out`` (..., D) f32
    and ``lse`` (...) are this shard's, ``all_max`` and ``all_sum`` reduce a
    tensor over the shards (collectives across ranks, or a reduction over a
    leading shard dim of stacked shards).  M = max lse, w = exp(lse - M) (0
    for a shard with no valid slot, lse = -inf), out = sum w out / sum w,
    the two sums in one reduction; 0 where every shard is empty, as K7 gives.
    -> the merged (..., D) f32."""
    m = all_max(lse)
    w = torch.where(lse == -torch.inf, 0.0, torch.exp(lse - m))
    acc = all_sum(torch.cat([out * w[..., None], w[..., None]], dim=-1))
    # the weights sum to 0 (every shard empty: so does the numerator) or to
    # at least 1 (the largest shard's weight is exp(0))
    return acc[..., :-1] / acc[..., -1:].clamp_min(1.0)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, softcap: Optional[float] = None,
                     scale: Optional[float] = None, return_lse: bool = False,
                     n_split: Optional[int] = None):
    """One query per row against a (ring) cache: q (B, H, D), k/v (B, T,
    KV, D), kv_len (B,) valid slots per row -> (B, H, D) in q's dtype, fp32
    inside.  The cache may be in another dtype than q.  ``return_lse``:
    (out, lse (B, H) f32), lse = -inf for a row with no valid slot (its out
    is 0).  ``n_split`` forces the split kernel's blocks per (row, kv head,
    head group) in place of ``split_plan``'s (a head's result depends on it
    alone: a check holds a call on some heads bit-equal to a call on all at
    one split).  A fake kv_len has no values: the recorded work takes every
    row as full (kv_len = T), which is what the dry run's decode at the
    cache's last position gives."""
    check_attention(q, k, v, 3)
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError(f"kv_len must be ({B},) on {q.device}")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    fake = build.is_fake(q, k, v, kv_len)
    if q.device.type == "cpu" and not fake:
        return ref.decode_attention_ref(q, k, v, kv_len, scale=scale, softcap=softcap,
                                        return_lse=return_lse)
    if D % 8 or D > MAX_D:
        raise ValueError(f"head width {D}: the kernel takes multiples of 8 up to {MAX_D}")
    if q.stride(-1) != 1:
        raise ValueError("q's last axis must be contiguous")
    check_vector_rows("k", k)
    check_vector_rows("v", v)
    kv_len = kv_len.to(torch.int32).contiguous()
    G = H // KV
    plan = split_plan(B, KV, T, G, D, k.element_size())
    n_split = plan["n_split"] if n_split is None else int(n_split)
    if n_split < 1:
        raise ValueError(f"n_split must be positive, not {n_split}")
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    n_part = B * KV * n_split * G          # one scratch buffer: m, l, then acc
    scr = torch.empty(n_part * (2 + D), dtype=torch.float32, device=q.device)
    if fake:   # what the kernel allocates (out, lse and the scratch) is all it does
        build.record_work("decode_attention", work(
            B, H, KV, D, B * T, q.element_size(), k.element_size(), return_lse))
        return (out, lse) if return_lse else out
    m_scr, l_scr, acc_scr = scr[:n_part], scr[n_part:2 * n_part], scr[2 * n_part:]
    build.launch(
        "decode_attention", "decode_attention_launch", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        m_scr.data_ptr(), l_scr.data_ptr(), acc_scr.data_ptr(),
        None if lse is None else lse.data_ptr(), B, T, H, KV, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), n_split, plan["heads_per_block"],
        plan["lanes_log2"], plan["pieces_per_lane"],
        -1.0 if softcap is None else float(softcap), scale,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16))
    LAUNCHES["decode_attention"] += 1
    if build.observing():   # the slots this call's rows hold (a host read, only when observed)
        # torch-lint: waive=T002(a host read only while a work observer runs: the dry run's check)
        slots = int(kv_len.clamp(0, T).sum())
        build.record_work("decode_attention", work(
            B, H, KV, D, slots, q.element_size(), k.element_size(), return_lse))
    return (out, lse) if return_lse else out
