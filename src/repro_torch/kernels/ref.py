"""Plain PyTorch versions of every ported kernel.

Each function computes what its CUDA kernel computes, on any device, with
ordinary tensor operations.  The wrappers (``sim_topk.py``, ``lsh_hash.py``)
run these for CPU tensors, the CPU tests hold them against the JAX package,
and ``chip_smoke.py`` holds each kernel against its plain version on the
card.  Nothing on the main path on the card calls them.

Like the kernels, the top-1 functions score a plain dot product: inputs are
unit rows (the reuse store normalises on insert).
"""
from __future__ import annotations

from typing import Tuple

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
