"""Wrappers of the cross-polytope hash kernels (``csrc/lsh_hash.cu``).

Port of the Pallas kernels ``repro/kernels/lsh_hash.py::lsh_hash_mix`` and
``::lsh_hash``.  For a CUDA tensor each wrapper checks its inputs, allocates
its output, launches the hand-written kernel on the current stream and counts
the launch; for a CPU tensor it runs the plain version in ``ref.py``.  There
is no fallback: a CUDA input either launches the kernel or raises.

The kernel takes the vertex as the first maximum of ``concat([proj, -proj])``
(``LSH.hash_batch``'s order); the Pallas kernel's argmax|proj| + sign bit
differs from that only on an exact |tie| between a positive and a negative
coordinate.
"""
from __future__ import annotations

import torch

from . import build, ref

#: launches of each kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"lsh_hash_mix": 0, "lsh_hash": 0}

# dynamic shared memory of one block: the (D, D) rotation + a 64-row x tile
_SMEM_LIMIT = 232448


def _check(x: torch.Tensor, rotations: torch.Tensor) -> None:
    if x.dim() != 2 or rotations.dim() != 4:
        raise ValueError("expected x (B, D) and rotations (T, K, D, D)")
    d = x.shape[1]
    if rotations.shape[2:] != (d, d):
        raise ValueError(f"rotations {tuple(rotations.shape)} do not match D={d}")
    if x.dtype != torch.float32 or rotations.dtype != torch.float32:
        raise TypeError("x and rotations must be float32")
    if x.device != rotations.device:
        raise ValueError("x and rotations must share one device")
    if not (x.is_contiguous() and rotations.is_contiguous()):
        raise ValueError("x and rotations must be contiguous")
    if x.device.type == "cuda" and (d * d + 64 * (d + 1)) * 4 > _SMEM_LIMIT:
        raise ValueError(f"D={d} is too large for the hash kernel's shared memory")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def lsh_hash_mix(x: torch.Tensor, rotations: torch.Tensor,
                 num_buckets: int) -> torch.Tensor:
    """x: (B, D); rotations: (T, K, D, D) -> (B, T) int32 mixed bucket ids."""
    _check(x, rotations)
    if num_buckets * 2 * x.shape[1] >= 2 ** 31:
        raise ValueError("num_buckets * 2D must stay below 2**31 (int32 mixing)")
    if x.device.type == "cpu":
        return ref.lsh_hash_mix_ref(x, rotations, num_buckets)
    b, d = x.shape
    t, k = rotations.shape[:2]
    out = torch.empty((b, t), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(build.load("lsh_hash").lsh_hash_mix_launch(
            x.data_ptr(), rotations.data_ptr(), out.data_ptr(), b, d, t, k,
            num_buckets, stream), "lsh_hash_mix_launch")
    LAUNCHES["lsh_hash_mix"] += 1
    return out


def lsh_hash(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """x: (B, D); rotations: (T, K, D, D) -> (B, T, K) int32 vertex ids."""
    _check(x, rotations)
    if x.device.type == "cpu":
        return ref.lsh_hash_ref(x, rotations)
    b, d = x.shape
    t, k = rotations.shape[:2]
    out = torch.empty((b, t, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(build.load("lsh_hash").lsh_hash_launch(
            x.data_ptr(), rotations.data_ptr(), out.data_ptr(), b, d, t, k,
            stream), "lsh_hash_launch")
    LAUNCHES["lsh_hash"] += 1
    return out
