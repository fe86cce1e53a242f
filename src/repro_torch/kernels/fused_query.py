"""One-call fused reuse query (port of ``repro/kernels/fused_query.py``).

The batched reuse lookup over the device-resident store, with exactly one
kernel launch (``reuse_top1``) per call:

    embs (B, D) ──┐
    proj          ├─> multiprobe_buckets ─> (B, T, P) probe buckets
    slots (T*NB,cap) ─> table gather ─────> (B, T*P*cap) raw candidate ids
    pages (P, S, D) ──> reuse_top1 kernel ─> (best (B,), idx (B,))
                        sort + run-length ─> exact unique-candidate counts

The probe math and the table gather are plain torch around the kernel, as
the JAX package leaves them to XLA around its Pallas kernel.  Candidate ids
go to the kernel raw (unsorted, duplicated, -1 for empty slots); its
lexicographic (max similarity, min id) best reproduces the staged path's
argmax over sorted unique candidates, and the count epilogue its
``candidate_counts`` statistics.  The candidate width T*P*cap is padded to a
multiple of 64.

The JAX module's ``FUSED_TRACE_COUNT`` (jit retraces) has no counterpart:
PyTorch runs eagerly and nothing is traced.  Capturing the call in a CUDA
graph is later work.
"""
from __future__ import annotations

import torch

from ..core.lsh import multiprobe_buckets
from .sim_topk import reuse_top1


def fused_query(embs: torch.Tensor, proj: torch.Tensor, slots_flat: torch.Tensor,
                pages: torch.Tensor, *, family: str, num_probes: int,
                gather_mode: str = "take", with_counts: bool = True):
    """hash -> probe -> gather -> top-1 with one kernel launch.

    embs: (B, D) unit rows; proj: (T, K, D, D) rotations (cross-polytope) or
    (T, bits, D) planes (hyperplane); slots_flat: (T * num_buckets,
    bucket_cap) int32 slot tables; pages: the store's (num_pages, page_size,
    D) embedding mirror, all on one device.

    Returns (best (B,) f32, idx (B,) int32 row ids with -1 = no candidate,
    extra): extra is the (B,) int32 exact unique-candidate counts when
    ``with_counts``, else the raw padded (B, Wp) candidate-id matrix.
    """
    b, d = embs.shape
    t = proj.shape[0]
    cap = slots_flat.shape[1]
    nb = slots_flat.shape[0] // t
    k = proj.shape[1] if family == "cross_polytope" else 1
    buckets, _ = multiprobe_buckets(
        embs, proj, family=family, dim=d, rotations_per_table=k,
        num_probes=num_probes, num_buckets=nb)          # (B, T, P)
    slots = slots_flat.view(t, nb, cap)
    t_idx = torch.arange(t, device=embs.device)[None, :, None]
    ids = slots[t_idx, buckets.long()].reshape(b, -1)   # (B, T*P*cap)
    w = ids.shape[1]
    wp = max(-(-w // 64) * 64, 64)
    if wp != w:
        ids = torch.cat([ids, ids.new_full((b, wp - w), -1)], dim=1)
    ids = ids.contiguous()
    val, idx = reuse_top1(embs, pages, ids, gather_mode=gather_mode)
    if not with_counts:
        return val, idx, ids
    # exact unique-candidate counts: -1 pads sort to the front, a run-length
    # count of the ascending tail matches the staged path's sorted-unique stats
    srt = torch.sort(ids, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    counts = ((srt >= 0) & first).sum(dim=1).to(torch.int32)
    return val, idx, counts
