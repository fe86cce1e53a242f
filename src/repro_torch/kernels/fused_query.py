"""One-call fused reuse query (port of ``repro/kernels/fused_query.py``).

The batched reuse lookup over the device-resident store, with exactly one
kernel launch (``reuse_top1_probed``) per call:

    embs (B, D) ──┐
    proj          ├─> multiprobe_buckets ─> (B, T, P) probe buckets
    slots (T*NB,cap) ─┐
    pages (P, S, D) ──┴─> reuse_top1_probed ─> (best (B,), idx (B,))
                  table gather + sort + run-length ─> exact unique-candidate counts

The probe math is plain torch around the kernel, as the JAX package leaves it
to XLA around its Pallas kernel.  The JAX pipeline gathers a (B, T*P*cap)
raw candidate-id matrix ``slots[t, buckets]`` and hands it to its top-1
kernel; here the kernel scores the probed slot rows bucket by bucket and
never needs that matrix, whose lexicographic (max similarity, min id) best
it reproduces.  The matrix is built only for the count epilogue, which
reproduces the staged path's ``candidate_counts`` statistics.

The JAX module's ``FUSED_TRACE_COUNT`` (jit retraces) has no counterpart:
PyTorch runs eagerly and nothing is traced.  Capturing the call in a CUDA
graph is later work.
"""
from __future__ import annotations

import torch

from ..core.lsh import multiprobe_buckets
from .ref import probed_candidate_ids
from .sim_topk import reuse_top1_probed


def candidate_counts(ids: torch.Tensor) -> torch.Tensor:
    """(B,) int32 distinct valid ids of each row of a raw (B, W) id matrix,
    on the matrix's device: -1 slots sort to the front, and a run-length
    count of the ascending tail matches the staged path's sorted-unique
    statistics."""
    srt = torch.sort(ids, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return ((srt >= 0) & first).sum(dim=1).to(torch.int32)


def fused_query(embs: torch.Tensor, proj: torch.Tensor, slots_flat: torch.Tensor,
                pages: torch.Tensor, *, family: str, num_probes: int,
                gather_mode: str = "take", with_counts: bool = True):
    """hash -> probe -> bucket-major top-1 with one kernel launch.

    embs: (B, D) unit rows; proj: (T, K, D, D) rotations (cross-polytope) or
    (T, bits, D) planes (hyperplane); slots_flat: (T * num_buckets,
    bucket_cap) int32 slot tables; pages: the store's (num_pages, page_size,
    D) embedding mirror, all on one device.

    Returns (best (B,) f32, idx (B,) int32 row ids with -1 = no candidate,
    counts): the (B,) int32 exact unique-candidate counts when
    ``with_counts``, else None.
    """
    d = embs.shape[1]
    t = proj.shape[0]
    nb = slots_flat.shape[0] // t
    k = proj.shape[1] if family == "cross_polytope" else 1
    buckets, _ = multiprobe_buckets(
        embs, proj, family=family, dim=d, rotations_per_table=k,
        num_probes=num_probes, num_buckets=nb)          # (B, T, P)
    val, idx = reuse_top1_probed(embs, pages, slots_flat, buckets.contiguous(),
                                 gather_mode=gather_mode)
    if not with_counts:
        return val, idx, None
    return val, idx, candidate_counts(probed_candidate_ids(slots_flat, buckets))
