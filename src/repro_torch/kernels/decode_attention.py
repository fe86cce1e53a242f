"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

Port of the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention``.  For a CUDA tensor the wrapper checks its inputs,
allocates the output and the split scratch, launches the hand-written kernel
(a split pass and a combine pass, or at wide heads a split pass whose last
block of each row combines) on the current stream and counts one
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
# Wide heads (D > WIDE_D: gemma's 256) come with few (row, kv head) groups.
# There a block serves one query head and a lane two 16-byte pieces of a
# row (its dots, butterflies and softmax are a lane's serial work: 8 heads
# a block and 32 lanes a row ran 3x slower at gemma-2b's decode on the
# H100), a split reads at least WIDE_SPLIT_BYTES of K, so that its loads
# outweigh its merge and its partial's write, and the last block of a
# row's splits merges them (no combine launch), which holds at most
# MAX_MERGE_SPLITS (the kernel's shared weights: kWarps * kMaxD).  Up to
# WIDE_D the plan is the one K7 was designed with.
WIDE_D = 128
WIDE_SPLIT_BYTES = 16384
MAX_MERGE_SPLITS = 1024


def heads_per_block(G: int) -> int:
    """Query heads one block serves (1, 2, 4 or 8): the least power of two
    that holds G, at most 8; more heads take more blocks."""
    return next(n for n in (1, 2, 4, 8) if n >= min(G, MAX_HEADS_PER_BLOCK))


def split_plan(batch: int, n_kv: int, slots: int, G: int = 1, D: int = 128,
               cache_bytes: int = 2) -> dict:
    """The split kernel's launch shape.  ``n_split`` blocks per (row, kv
    head, head group): enough that the grid holds TARGET_BLOCKS, but no more
    than ``min_chunk``-slot pieces of the cache.  Each row then cuts its own
    valid slots, min(kv_len, T), into ``row_chunk`` pieces of at least
    ``min_chunk`` on the card.  A cache row of D elements is read 16 bytes a
    lane by ``lanes`` lanes, ``pieces_per_lane`` pieces each.  ``combine``:
    "kernel" (a second launch merges each row's splits) or, for wide heads,
    "last_block" (the last split block of a (row, kv head, head group)
    merges them; the kernel takes this route where ``pieces_per_lane`` is
    2, which only wide heads get)."""
    wide = D > WIDE_D
    hpb = 1 if wide else heads_per_block(G)
    groups = batch * n_kv * -(-G // hpb)
    min_chunk = CHUNK_ALIGN
    if wide:
        min_chunk = max(CHUNK_ALIGN, -(-WIDE_SPLIT_BYTES // (D * cache_bytes * CHUNK_ALIGN))
                        * CHUNK_ALIGN)
    n_split = max(1, min(-(-TARGET_BLOCKS // max(groups, 1)), -(-max(slots, 1) // min_chunk)))
    pieces = D * cache_bytes // 16
    per_lane = 2 if wide else 1        # a wide row: two pieces a lane, fewer shuffles a dot
    lanes = min(32, 1 << max(0, (-(-pieces // per_lane) - 1).bit_length()))
    return {"n_split": n_split, "heads_per_block": hpb, "head_groups": -(-G // hpb),
            "lanes": lanes, "lanes_log2": lanes.bit_length() - 1,
            "pieces_per_lane": -(-pieces // lanes),
            "grid": (n_split, n_kv * -(-G // hpb), batch),
            "min_chunk": min_chunk, "combine": "last_block" if wide else "kernel"}


def row_chunk(length: int, n_split: int, min_chunk: int = CHUNK_ALIGN) -> int:
    """Slots per split of a row with ``length`` valid slots, as the kernel
    plans it: ceil(length / n_split) rounded up to CHUNK_ALIGN, at least
    ``min_chunk`` (the plan's).  Split s covers [s * chunk, min((s + 1) *
    chunk, length)); the splits past the row's end read nothing."""
    c = -(-length // n_split)
    return max(min_chunk, -(-c // CHUNK_ALIGN) * CHUNK_ALIGN)


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
    last_block = plan["combine"] == "last_block"
    if last_block and n_split > MAX_MERGE_SPLITS:
        raise ValueError(f"n_split {n_split}: the last block merges at most "
                         f"{MAX_MERGE_SPLITS} splits")
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    n_part = B * KV * n_split * G          # one scratch buffer: acc, m, l, then tickets
    n_tickets = B * KV * plan["head_groups"] if last_block else 0
    scr = torch.empty(n_part * (2 + D) + n_tickets, dtype=torch.float32, device=q.device)
    if fake:   # what the kernel allocates (out, lse and the scratch) is all it does
        build.record_work("decode_attention", work(
            B, H, KV, D, B * T, q.element_size(), k.element_size(), return_lse))
        return (out, lse) if return_lse else out
    m0, end = n_part * D, n_part * (2 + D)   # acc first: its rows are 16-byte aligned
    acc_scr, m_scr, l_scr = scr[:m0], scr[m0:m0 + n_part], scr[m0 + n_part:end]
    tickets = scr[end:].view(torch.int32) if last_block else None
    build.launch(
        "decode_attention", "decode_attention_launch", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        m_scr.data_ptr(), l_scr.data_ptr(), acc_scr.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        None if lse is None else lse.data_ptr(), B, T, H, KV, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), n_split, plan["min_chunk"],
        plan["heads_per_block"], plan["lanes_log2"], plan["pieces_per_lane"],
        -1.0 if softcap is None else float(softcap), scale,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16))
    LAUNCHES["decode_attention"] += 1
    if build.observing():   # the slots this call's rows hold (a host read, only when observed)
        # torch-lint: waive=T002(a host read only while a work observer runs: the dry run's check)
        slots = int(kv_len.clamp(0, T).sum())
        build.record_work("decode_attention", work(
            B, H, KV, D, slots, q.element_size(), k.element_size(), return_lse))
    return (out, lse) if return_lse else out
