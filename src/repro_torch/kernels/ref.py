"""Plain PyTorch versions of every ported kernel.

Each function computes what its CUDA kernel computes, on any device, with
ordinary tensor operations.  The wrappers (``sim_topk.py``, ``lsh_hash.py``,
``flash_attention.py``, ``decode_attention.py``) run these for CPU tensors,
the CPU tests hold them against the JAX package, and ``chip_smoke.py`` holds
each kernel against its plain version on the card.  Nothing on the main path
on the card calls them.

Like the kernels, the gathered top-1 functions score a plain dot product:
inputs are unit rows (the reuse store normalises on insert).  ``sim_top1_ref``
normalises, as the reference's oracle does; its kernel does not.

The attention functions follow the kernels' masking: a masked logit is
-1e30 and weighs exactly 0, and the denominator is clamped at 1e-30, so a
row with every logit masked gives 0.  (The reference's jnp oracles give such
a row the mean of V instead; every other row agrees.)
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..device import fp32_matmul

_IMAX = torch.iinfo(torch.int32).max


# ------------------------------------------------------------------- lsh_hash
def lsh_hash_ref(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Cross-polytope vertex ids.  x: (B, D); rotations: (T, K, D, D).

    Returns (B, T, K) int32 vertex ids in [0, 2D): the first maximum of
    ``concat([R x, -R x])`` (v < D means +e_v, v >= D means -e_{v-D}).
    """
    with fp32_matmul():
        proj = torch.einsum("tkde,be->btkd", rotations.float(), x.float())
    return torch.argmax(torch.cat([proj, -proj], dim=-1), dim=-1).to(torch.int32)


def lsh_hash_mix_ref(x: torch.Tensor, rotations: torch.Tensor,
                     num_buckets: int) -> torch.Tensor:
    """(B, D) x (T, K, D, D) -> (B, T) int32: vertex ids folded over K as
    ``acc = (acc * 2D + vid) % num_buckets``."""
    vids = lsh_hash_ref(x, rotations)
    radix = 2 * x.shape[-1]
    acc = torch.zeros(vids.shape[:2], dtype=torch.int32, device=vids.device)
    for k in range(vids.shape[-1]):
        acc = (acc * radix + vids[..., k]) % num_buckets
    return acc


# ------------------------------------------------------------------- sim_topk
def _gather_scores(q: torch.Tensor, store: torch.Tensor,
                   cand_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, C) dot scores of each candidate row (-inf where id < 0) + validity.

    A paged ``(P, S, D)`` store maps id -> (min(id // S, P - 1), id % S); a
    flat ``(N, D)`` store clips id to N - 1 (``jnp.take`` mode="clip")."""
    ids = cand_ids.long()
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    if store.dim() == 3:
        n_pages, page_size = store.shape[0], store.shape[1]
        rows = (torch.clamp(safe // page_size, max=n_pages - 1) * page_size
                + safe % page_size)
        flat = store.reshape(-1, store.shape[-1])
    else:
        rows = torch.clamp(safe, max=store.shape[0] - 1)
        flat = store
    cand = flat.float()[rows]                               # (Q, C, D)
    scores = (cand * q.float()[:, None, :]).sum(-1)
    return torch.where(valid, scores, torch.full_like(scores, -torch.inf)), valid


def gather_top1_ref(q: torch.Tensor, store: torch.Tensor,
                    cand_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-1 over sorted, unique, front-packed candidates.

    Returns (best (Q,) f32, idx (Q,) int32): a tie goes to the first
    position; (-inf, -1) for a query without a valid candidate."""
    if cand_ids.shape[1] == 0:
        return (torch.full((q.shape[0],), -torch.inf, device=q.device),
                torch.full((q.shape[0],), -1, dtype=torch.int32, device=q.device))
    scores, _ = _gather_scores(q, store, cand_ids)
    best, pos = torch.max(scores, dim=-1)  # first maximal position
    idx = torch.gather(cand_ids.long(), 1, pos[:, None])[:, 0]
    idx = torch.where(torch.isfinite(best), idx, torch.full_like(idx, -1))
    return best, idx.to(torch.int32)


def reuse_top1_ref(q: torch.Tensor, store: torch.Tensor,
                   cand_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic (max cosine, min row id) top-1 over raw table candidates
    (unsorted, duplicated, -1 = empty slot).  (-inf, -1) when a query has no
    valid candidate."""
    if cand_ids.shape[1] == 0:
        return gather_top1_ref(q, store, cand_ids)
    scores, valid = _gather_scores(q, store, cand_ids)
    best = scores.max(dim=-1).values
    elig = valid & (scores >= best[:, None])
    ids = cand_ids.to(torch.int32)
    idx = torch.where(elig, ids, torch.full_like(ids, _IMAX)).min(dim=-1).values
    idx = torch.where(torch.isfinite(best), idx, torch.full_like(idx, -1))
    return best, idx


def probed_candidate_ids(slots_flat: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """The fused query's table gather: (B, T*P*cap) int32 raw candidate ids
    ``slots[t, buckets[b, t, p]]``, flattened in (t, p, slot) order.

    slots_flat: (T * num_buckets, cap) int32 slot tables; buckets: (B, T, P)
    int32 probe buckets from ``multiprobe_buckets``."""
    b, t, _ = buckets.shape
    slots = slots_flat.view(t, slots_flat.shape[0] // t, slots_flat.shape[1])
    t_idx = torch.arange(t, device=buckets.device)[None, :, None]
    return slots[t_idx, buckets.long()].reshape(b, -1)


def reuse_top1_probed_ref(q: torch.Tensor, pages: torch.Tensor, slots_flat: torch.Tensor,
                          buckets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reuse_top1_ref`` over the probed slot rows: the table gather, then
    the lexicographic (max cosine, min row id) top-1."""
    return reuse_top1_ref(q, pages, probed_candidate_ids(slots_flat, buckets))


def sim_top1_ref(q: torch.Tensor, store: torch.Tensor, n_valid: Optional[int] = None,
                 *, chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force cosine top-1: q (Q, D) x store (N, D), f32 or bf16.

    Rows at or after ``n_valid`` are masked.  Returns (best (Q,) f32, idx
    (Q,) int32): the first index of the maximum, (-inf, 0) when no row is
    valid.  The store is scored ``chunk`` rows at a time (strict ``>``
    across chunks keeps the first maximum), so (Q, N) is never
    materialised."""
    def unit(x):
        x = x.float()
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    n = store.shape[0] if n_valid is None else max(0, min(int(n_valid), store.shape[0]))
    qn = unit(q)
    best = torch.full((q.shape[0],), -torch.inf, device=q.device)
    idx = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for lo in range(0, n, chunk):
        with fp32_matmul():
            s = qn @ unit(store[lo:min(lo + chunk, n)]).T
        val, arg = s.max(dim=1)              # first maximal index in the chunk
        better = val > best
        best = torch.where(better, val, best)
        idx = torch.where(better, arg + lo, idx)
    return best, idx.to(torch.int32)


# ------------------------------------------------------------------- attention
def _softmax_masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Kernel softmax: masked logits -1e30 with weight 0, sum clamped at
    1e-30."""
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True)) * mask
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _attention_mask(S: int, T: int, causal: bool, window: Optional[int],
                    device, q_offset: int = 0) -> torch.Tensor:
    """(S, T): row s, at position s + ``q_offset``, sees t where ``t <= s +
    q_offset`` (causal) and ``t > s + q_offset - window`` (window)."""
    sidx = torch.arange(S, device=device)[:, None] + q_offset
    tidx = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= tidx <= sidx
    if window is not None:
        mask &= tidx > sidx - window
    return mask


def _scaled_logits(qg: torch.Tensor, k: torch.Tensor, scale: float,
                   softcap: Optional[float]):
    """(B, KV, G, S, T) fp32 logits ``softcap(scale * q.k)`` and, with a
    softcap, tanh of the capped argument (the backward needs it)."""
    with fp32_matmul():
        logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap is None:
        return logits, None
    th = torch.tanh(logits / softcap)
    return softcap * th, th


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None, return_lse: bool = False,
                        q_offset: int = 0):
    """GQA prefill attention.  q (B, S, H, D), k/v (B, T, KV, D) -> (B, S,
    H, D) in q's dtype; logits and softmax in fp32.  Row s is position s +
    ``q_offset`` (a chunk of a longer prompt) and sees t where ``t <= s +
    q_offset`` (causal) and ``t > s + q_offset - window`` (window).

    ``return_lse``: also return each row's log-sum-exp of its visible
    logits, (B, H, S) fp32, what the backward recomputes the probabilities
    from (``p = exp(logit - lse)``).  A row that sees no key has lse = +inf,
    so every p of it is 0 (as FlashAttention-2 defines it)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits, _ = _scaled_logits(q.reshape(B, S, KV, G, D).float(), k, scale, softcap)
    mask = _attention_mask(S, T, causal, window, q.device, q_offset)
    probs = _softmax_masked(logits, mask)
    with fp32_matmul():
        out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    out = out.reshape(B, S, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.masked_fill(~mask, -torch.inf), dim=-1)
    return out, lse.masked_fill(lse == -torch.inf, torch.inf).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None, q_offset: int = 0):
    """The gradient of ``flash_attention_ref`` -> (dq, dk, dv) in q's, k's
    and v's dtypes, written out as the backward kernel computes it (not
    through autograd), all in fp32:

        P  = exp(softcap(scale q.k) - lse), 0 where masked
        dV = P^T dO          dP = dO V^T          delta = rowsum(dO * O)
        dS = P * (dP - delta) * (1 - tanh^2(scale q.k / softcap))
        dQ = scale dS K      dK = scale dS^T Q

    The G query heads of a kv head sum into its dK and dV.  ``out`` and
    ``lse`` are the forward's (lse from ``return_lse``)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KV, G, D).float()
    logits, th = _scaled_logits(qg, k, scale, softcap)
    mask = _attention_mask(S, T, causal, window, q.device, q_offset)
    p = torch.where(mask, torch.exp(logits - lse.reshape(B, KV, G, S, 1)),
                    torch.zeros_like(logits))
    do = dout.reshape(B, S, KV, G, D).float()
    delta = (do * out.reshape(B, S, KV, G, D).float()).sum(-1).permute(0, 2, 3, 1)
    with fp32_matmul():
        dv = torch.einsum("bkgst,bskgd->btkd", p, do)
        dp = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    with fp32_matmul():
        dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
        dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, *, scale: Optional[float] = None,
                         softcap: Optional[float] = None, return_lse: bool = False):
    """One-query attention over a cache.  q (B, H, D), k/v (B, T, KV, D),
    kv_len (B,): slots ``t < kv_len[b]`` are valid.  -> (B, H, D) in q's
    dtype; a row with no valid slot gives 0.  ``return_lse``: also each
    row's log-sum-exp of its valid logits, (B, H) f32, -inf for a row with
    no valid slot."""
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    if T == 0:   # an empty cache (an empty shard of one): no valid slot in any row
        out = q.new_zeros((B, H, D))
        lse = torch.full((B, H), -torch.inf, device=q.device)
        return (out, lse) if return_lse else out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D).float()
    with fp32_matmul():
        logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = torch.arange(T, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    probs = _softmax_masked(logits, mask[:, None, None, :])
    with fp32_matmul():
        out = torch.einsum("bkgt,btkd->bkgd", probs, v.float())
    out = out.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.masked_fill(~mask[:, None, None, :], -torch.inf), dim=-1)
    return out, lse.reshape(B, H)
