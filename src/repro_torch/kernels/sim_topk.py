"""Wrappers of the masked cosine top-1 kernels (``csrc/sim_topk.cu``).

Port of the Pallas kernels ``repro/kernels/sim_topk.py::reuse_top1``,
``::gather_top1`` and ``::sim_top1``.  For a CUDA tensor each wrapper checks
its inputs, allocates its outputs (and scratch), launches the hand-written
kernel on the current stream and counts the launch; for a CPU tensor it runs
the plain version in ``ref.py``.  There is no fallback: a CUDA input either
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import build, ref

#: launches of each kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"reuse_top1": 0, "gather_top1": 0, "sim_top1": 0}

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


SIM_ROWS = 64            # queries per block of the sim_top1 kernel
SIM_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def sim_top1(q: torch.Tensor, store: torch.Tensor,
             n_valid: Optional[Union[int, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force top-1 over a whole store: q (Q, D) x store (N, D), both
    float32 or both bfloat16.  Rows at or after ``n_valid`` (default N; a
    tensor is read on the host) are masked.  Returns (best (Q,) f32, idx
    (Q,) int32), the first index of the maximum and (-inf, 0) when no row
    is valid.  The kernel scores plain dots (unit rows expected); the plain
    version used for CPU tensors normalises."""
    if q.dim() != 2 or store.dim() != 2 or q.shape[1] != store.shape[1]:
        raise ValueError(f"expected q (Q, D), store (N, D); got {tuple(q.shape)}, "
                         f"{tuple(store.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or store.dtype != q.dtype:
        raise TypeError("q and store must both be float32 or both bfloat16")
    if q.device != store.device:
        raise ValueError("q and store must share one device")
    n = store.shape[0] if n_valid is None else max(0, min(int(n_valid), store.shape[0]))
    if q.device.type == "cpu":
        return ref.sim_top1_ref(q, store, n)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n_q, d = q.shape
    if d % 4:
        raise ValueError(f"row width {d} is not a multiple of 4")
    if not (q.is_contiguous() and store.is_contiguous()):
        raise ValueError("q and store must be contiguous")
    q_tiles = -(-n_q // SIM_ROWS)
    want = max(1, min(-(-n // 4096), -(-SIM_TARGET_BLOCKS // max(q_tiles, 1))))
    per_split = -(-max(n, 1) // want)
    chunk = -(-per_split // SIM_ROWS) * SIM_ROWS
    n_split = -(-max(n, 1) // chunk)
    val = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    part_val = torch.empty((n_split, n_q), dtype=torch.float32, device=q.device)
    part_idx = torch.empty((n_split, n_q), dtype=torch.int32, device=q.device)
    lib = build.load("sim_topk")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib.sim_top1_launch(
            q.data_ptr(), store.data_ptr(), val.data_ptr(), idx.data_ptr(),
            part_val.data_ptr(), part_idx.data_ptr(), n_q, d, n, n_split, chunk,
            int(q.dtype == torch.bfloat16), stream), "sim_top1_launch")
    LAUNCHES["sim_top1"] += 1
    return val, idx
