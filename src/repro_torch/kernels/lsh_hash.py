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

import functools
from typing import Optional

import torch

from . import build, ref

#: launches of each kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"lsh_hash_mix": 0, "lsh_hash": 0}

SMS = 132                # streaming multiprocessors of an H100
LANES = GROUPS = 16      # a block: 16 row groups of 16 lanes


def launch_plan(b: int, d: int, t: int, row_slots: Optional[int] = None) -> dict:
    """Shapes of the register-tiled hash kernel for (B, D) rows and T tables.

    A lane computes ``proj_per_lane`` projections of ``row_slots`` rows; a
    block takes ``tile_rows`` = 16 * row_slots rows of one table and a slab
    of ``slab`` = 16 * proj_per_lane rows of a rotation at a time.  Tiles
    are the largest of 64, 32 and 16 rows that still give the card's 132
    SMs a block each (a larger tile reads each rotation for more rows),
    unless ``row_slots`` (1, 2 or 4) names the tile.  Raises where the tile
    and the slab do not fit in shared memory."""
    kj = 2 if d <= 32 else 4 if d <= 64 else 8
    slab = LANES * kj

    def smem_of(r: int) -> int:
        return (GROUPS * r + slab) * (-(-d // 4) * 4 + 4) * 4

    if row_slots is not None and row_slots not in (1, 2, 4):
        raise ValueError(f"row_slots must be 1, 2 or 4, not {row_slots}")
    ri = row_slots or next((r for r in (4, 2) if -(-b // (r * GROUPS)) * t >= SMS
                            and smem_of(r) <= build.SMEM_LIMIT), 1)
    tile, smem = GROUPS * ri, smem_of(ri)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"D={d} is too large for the hash kernel's shared memory")
    return {"row_slots": ri, "proj_per_lane": kj, "tile_rows": tile, "slab": slab,
            "slabs": -(-d // slab), "threads": LANES * GROUPS,
            "grid": (-(-b // tile), t), "smem_bytes": smem}


_plan = functools.lru_cache(maxsize=256)(launch_plan)


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def launch(fn: str, x: torch.Tensor, rotations: torch.Tensor, out: torch.Tensor,
           *extra: int, plan: Optional[dict] = None) -> torch.Tensor:
    """Launch C function ``fn`` of the hash library on CUDA tensors that the
    wrappers accept, with ``plan`` (default ``launch_plan``'s), and count
    the launch."""
    b, d = x.shape
    t, k = rotations.shape[:2]
    plan = plan or _plan(b, d, t)
    build.launch("lsh_hash", fn, x.device, x.data_ptr(), rotations.data_ptr(), out.data_ptr(),
                 b, d, t, k, *extra, plan["row_slots"], plan["proj_per_lane"],
                 plan["smem_bytes"])
    LAUNCHES[fn[:-len("_launch")]] += 1
    return out


def lsh_hash_mix(x: torch.Tensor, rotations: torch.Tensor,
                 num_buckets: int) -> torch.Tensor:
    """x: (B, D); rotations: (T, K, D, D) -> (B, T) int32 mixed bucket ids."""
    _check(x, rotations)
    if num_buckets * 2 * x.shape[1] >= 2 ** 31:
        raise ValueError("num_buckets * 2D must stay below 2**31 (int32 mixing)")
    if x.device.type == "cpu":
        return ref.lsh_hash_mix_ref(x, rotations, num_buckets)
    out = torch.empty(x.shape[0], rotations.shape[0], dtype=torch.int32, device=x.device)
    return launch("lsh_hash_mix_launch", x, rotations, out, num_buckets)


def lsh_hash(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """x: (B, D); rotations: (T, K, D, D) -> (B, T, K) int32 vertex ids."""
    _check(x, rotations)
    if x.device.type == "cpu":
        return ref.lsh_hash_ref(x, rotations)
    out = torch.empty(x.shape[0], *rotations.shape[:2], dtype=torch.int32, device=x.device)
    return launch("lsh_hash_launch", x, rotations, out)
