"""Wrappers of the masked cosine top-1 kernels (``csrc/sim_topk.cu``).

Port of the Pallas kernels ``repro/kernels/sim_topk.py::reuse_top1`` and
``::gather_top1``.  For a CUDA tensor each wrapper checks its inputs, allocates
its outputs, launches the hand-written kernel on the current stream and counts
the launch; for a CPU tensor it runs the plain version in ``ref.py``.  There
is no fallback: a CUDA input either launches the kernel or raises.

The brute-force ``sim_top1`` (Pallas ``sim_top1``) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build, ref

#: launches of each kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"reuse_top1": 0, "gather_top1": 0}

GATHER_MODES = ("take", "onehot")


def _check(q: torch.Tensor, store: torch.Tensor, cand_ids: torch.Tensor) -> None:
    if q.dim() != 2 or cand_ids.dim() != 2 or store.dim() not in (2, 3):
        raise ValueError("expected q (Q, D), store (N, D) | (P, S, D), ids (Q, C)")
    if q.shape[0] != cand_ids.shape[0] or q.shape[1] != store.shape[-1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, store "
                         f"{tuple(store.shape)}, ids {tuple(cand_ids.shape)}")
    if q.dtype != torch.float32 or store.dtype != torch.float32:
        raise TypeError("q and store must be float32")
    if cand_ids.dtype != torch.int32:
        raise TypeError("cand_ids must be int32")
    if not (q.device == store.device == cand_ids.device):
        raise ValueError("q, store and cand_ids must share one device")
    if not (q.is_contiguous() and store.is_contiguous() and cand_ids.is_contiguous()):
        raise ValueError("q, store and cand_ids must be contiguous")
    if store.numel() == 0:
        raise ValueError("empty store")


def _launch(fn: str, q: torch.Tensor, store: torch.Tensor,
            cand_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n_q, n_c = cand_ids.shape
    # a flat (N, D) store is a paged one with one row per page
    pages, page_size = (store.shape[0], store.shape[1]) if store.dim() == 3 \
        else (store.shape[0], 1)
    val = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    lib = build.load("sim_topk")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(getattr(lib, fn)(
            q.data_ptr(), cand_ids.data_ptr(), store.data_ptr(), val.data_ptr(),
            idx.data_ptr(), n_q, n_c, q.shape[1], pages, page_size, stream), fn)
    return val, idx


def reuse_top1(q: torch.Tensor, store: torch.Tensor, cand_ids: torch.Tensor,
               *, gather_mode: str = "take") -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-1 with lowest-id tie-break over raw table candidates.

    q: (Q, D) unit rows; store: flat (N, D) or paged (P, S, D); cand_ids:
    (Q, C) int32 row ids straight from the slot tables (unsorted, duplicated,
    -1 = empty slot).  Returns (best (Q,) f32, idx (Q,) int32), (-inf, -1)
    for a query without a valid candidate.  ``gather_mode`` ("take" |
    "onehot") is accepted for the reference's signature: the one-hot gather
    exists for TPUs whose dynamic gather does not lower, and both modes give
    the same result here.
    """
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}")
    _check(q, store, cand_ids)
    if q.device.type == "cpu":
        return ref.reuse_top1_ref(q, store, cand_ids)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch("reuse_top1_launch", q, store, cand_ids)
    LAUNCHES["reuse_top1"] += 1
    return out


def gather_top1(q: torch.Tensor, store: torch.Tensor,
                cand_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-1 over sorted, unique, front-packed candidates
    (-1 padded): a tie goes to the first position.  Same shapes as
    ``reuse_top1``."""
    _check(q, store, cand_ids)
    if q.device.type == "cpu":
        return ref.gather_top1_ref(q, store, cand_ids)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch("gather_top1_launch", q, store, cand_ids)
    LAUNCHES["gather_top1"] += 1
    return out
