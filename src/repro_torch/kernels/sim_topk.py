"""Wrappers of the masked cosine top-1 kernels (``csrc/sim_topk.cu``).

Port of the Pallas kernels ``repro/kernels/sim_topk.py::reuse_top1``,
``::gather_top1`` and ``::sim_top1``.  ``reuse_top1`` has two routes: an
arbitrary (Q, C) id matrix (``csrc/sim_topk.cu``), and the bucket-major
``reuse_top1_probed`` over the probed slot tables (``csrc/reuse_probed.cu``)
that the fused query calls.  The id route and ``gather_top1`` share one
kernel, split over candidates by ``gather_plan``; ``sim_top1`` runs
register tiles planned by ``sim_plan``.  For a CUDA tensor each wrapper checks
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
LAUNCHES = {"reuse_top1": 0, "reuse_top1_probed": 0, "gather_top1": 0, "sim_top1": 0}

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


# gather_top1 and the id route of reuse_top1: a block of up to 4 warps takes
# one query and a split of its candidates; a warp stages 32 candidates' rows
# at once, in two stages (``csrc/sim_topk.cu``)
GATHER_GROUP = 32                          # candidates a warp stages at once
GATHER_WARPS = 4                           # warps a block where shared memory allows
GATHER_MIN_CHUNK, GATHER_MAX_CHUNK = 512, 2048   # candidates a block
SMS, SM_SMEM = 132, 233472                 # an H100's SMs and the shared memory of one


def gather_plan(b: int, c: int, d: int, aligned: bool = True,
                chunk: Optional[int] = None) -> dict:
    """Blocks of the gather kernel for B queries of C candidates, rows of
    width D.  Splits of 512-2048 candidates (``chunk`` forces one): as many
    as fit in one wave of the card's block slots (shared memory decides how
    many blocks an SM holds: 3 at D=64), at least C / 2048 and at most
    C / 512.  16-byte copies (row stride D + 4) where D % 4 == 0 and q and
    the store are ``aligned`` on 16 bytes, else 4-byte ones (stride D | 1).
    A warp stages GATHER_GROUP rows at once in each of two stages, fewer
    where D is too wide for that (then one warp a block).  Raises where one
    row a stage does not fit."""
    ld = d + 4 if d % 4 == 0 and aligned else d | 1
    q_bytes = 4 * (-(-d // 4) * 4)
    group = GATHER_GROUP
    while group > 1 and q_bytes + 2 * group * ld * 4 > build.SMEM_LIMIT:
        group //= 2
    per_warp = 2 * group * ld * 4
    warps = min(GATHER_WARPS, (build.SMEM_LIMIT - q_bytes) // per_warp)
    if warps < 1:
        raise ValueError(f"D={d} is too wide for the gather kernel's shared memory")
    smem = q_bytes + warps * per_warp
    slots = SMS * max(1, min(2048 // (32 * warps), SM_SMEM // (smem + 1024)))
    step = group * warps                   # candidates a block stages at once
    if chunk is None:
        lo = -(-c // GATHER_MAX_CHUNK)
        hi = max(1, -(-c // GATHER_MIN_CHUNK))
        chunk = -(-c // min(max(slots // max(b, 1), lo), hi))
    chunk = max(step, -(-chunk // step) * step)
    splits = max(1, -(-c // chunk))
    return {"splits": splits, "chunk": chunk, "group": group, "threads": 32 * warps,
            "smem_bytes": smem, "blocks": b * splits, "slots": slots}


def _aligned(*xs: torch.Tensor, to: int = 16) -> bool:
    return all(x.data_ptr() % to == 0 for x in xs)


def launch_gather(fn: str, q: torch.Tensor, store: torch.Tensor, cand_ids: torch.Tensor,
                  plan: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``gather_top1_launch`` or ``reuse_top1_launch`` with ``plan``
    (default ``gather_plan``) on CUDA tensors that the wrapper accepts, and
    count the launch."""
    n_q, n_c = cand_ids.shape
    d = q.shape[1]
    if plan is None:
        plan = gather_plan(n_q, n_c, d, _aligned(q, store))
    # a flat (N, D) store is a paged one with one row per page
    pages, page_size = (store.shape[0], store.shape[1]) if store.dim() == 3 \
        else (store.shape[0], 1)
    keys = torch.empty(n_q, dtype=torch.int64, device=q.device)
    val = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    build.launch("sim_topk", fn, q.device, q.data_ptr(), cand_ids.data_ptr(), store.data_ptr(),
                 keys.data_ptr(), val.data_ptr(), idx.data_ptr(), n_q, n_c, d, pages,
                 page_size, plan["splits"], plan["chunk"], plan["group"], plan["threads"],
                 plan["smem_bytes"])
    LAUNCHES[fn.removesuffix("_launch")] += 1
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
    return launch_gather("reuse_top1_launch", q, store, cand_ids)


# the bucket-major kernel: 64 slots a block; dense blocks (64 x 64 tiles of
# queries x store rows) from PROBED_DENSE_MIN expected probers a slot row up,
# sparse ones (a thread a slot, its row in registers) below: the two cross
# between 4 and 8 on the serve store (chip_smoke.py's bucket-route sweep)
PROBED_ROWS = 64
PROBED_DENSE_MIN = 8
#: the sparse blocks' plan: 64 threads, no dynamic shared memory
SPARSE_PLAN = {"sparse": True, "threads": PROBED_ROWS, "smem_bytes": 0}


def dense_plan(d: int) -> dict:
    """The dense blocks' plan for rows of width D: 256 threads, 64 store rows
    and two stages of 64 query rows in shared memory (rows of round4(D) + 4
    floats).  Raises where they do not fit."""
    smem = 3 * PROBED_ROWS * (-(-d // 4) * 4 + 4) * 4
    if smem + 4 * PROBED_ROWS > build.SMEM_LIMIT:     # + the block's static slot ids
        raise ValueError(f"D={d} is too wide for the bucket-major kernel's shared memory")
    return {"sparse": False, "threads": 256, "smem_bytes": smem}


def probed_plan(b: int, p: int, num_buckets: int, d: int, aligned: bool = True) -> dict:
    """Blocks of the bucket-major kernel for B queries of P probes a table
    over NB buckets, rows of width D.  A slot row expects B * P / NB probers:
    below PROBED_DENSE_MIN the sparse blocks, which hold a row in 16-byte
    registers and so need D % 4 == 0, D <= 128 and 16-byte ``aligned``
    queries and store; else, and from PROBED_DENSE_MIN up, the dense ones
    (``dense_plan``)."""
    if b * p < PROBED_DENSE_MIN * num_buckets and d % 4 == 0 and d <= 128 and aligned:
        return dict(SPARSE_PLAN)
    return dense_plan(d)


def probe_inversion(buckets: torch.Tensor, num_buckets: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert (B, T, P) probe buckets into the queries that probe each slot
    row ``t * num_buckets + bucket``: (offsets (T * num_buckets + 1,) int32,
    probers (B * T * P,) int32), slot row r's probers in query order at
    ``probers[offsets[r]:offsets[r + 1]]``.  Plain torch on the buckets'
    device (a stable sort and a search), with no host read."""
    b, t, p = buckets.shape
    dev = buckets.device
    keys = buckets + torch.arange(0, t * num_buckets, num_buckets, dtype=torch.int32,
                                  device=dev)[None, :, None]
    skeys, order = torch.sort(keys.reshape(-1), stable=True)
    probers = torch.div(order, t * p, rounding_mode="floor").to(torch.int32)
    offsets = torch.searchsorted(
        skeys, torch.arange(t * num_buckets + 1, dtype=torch.int32, device=dev), out_int32=True)
    return offsets, probers


def reuse_top1_probed(q: torch.Tensor, pages: torch.Tensor, slots_flat: torch.Tensor,
                      buckets: torch.Tensor, *, gather_mode: str = "take"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reuse_top1(q, pages, slots[t, buckets].reshape(B, -1))`` without the
    id matrix: scored bucket by bucket.

    q: (B, D) unit rows; pages: paged (P, S, D) or flat (N, D) store;
    slots_flat: (T * NB, cap) int32 slot tables (-1 = empty); buckets: (B,
    T, P) int32 probe buckets (``multiprobe_buckets``).  Returns (best (B,)
    f32, idx (B,) int32): the lowest row id among the maxima, (-inf, -1) for
    a query without a valid candidate.  ``gather_mode`` as in ``reuse_top1``.
    """
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}")
    if q.dim() != 2 or pages.dim() not in (2, 3) or slots_flat.dim() != 2 \
            or buckets.dim() != 3:
        raise ValueError("expected q (B, D), pages (N, D) | (P, S, D), slots (T*NB, cap), "
                         "buckets (B, T, P)")
    b, d = q.shape
    t = buckets.shape[1]
    if buckets.shape[0] != b or pages.shape[-1] != d or slots_flat.shape[0] % t:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages {tuple(pages.shape)}, "
                         f"slots {tuple(slots_flat.shape)}, buckets {tuple(buckets.shape)}")
    if q.dtype != torch.float32 or pages.dtype != torch.float32:
        raise TypeError("q and pages must be float32")
    if slots_flat.dtype != torch.int32 or buckets.dtype != torch.int32:
        raise TypeError("slots_flat and buckets must be int32")
    if not (q.device == pages.device == slots_flat.device == buckets.device):
        raise ValueError("q, pages, slots_flat and buckets must share one device")
    if not all(x.is_contiguous() for x in (q, pages, slots_flat, buckets)):
        raise ValueError("q, pages, slots_flat and buckets must be contiguous")
    if pages.numel() == 0:
        raise ValueError("empty store")
    if q.device.type == "cpu":
        return ref.reuse_top1_probed_ref(q, pages, slots_flat, buckets)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    rows = slots_flat.shape[0]
    aligned = q.data_ptr() % 16 == 0 and pages.data_ptr() % 16 == 0
    return launch_probed(q, pages, slots_flat, buckets,
                         probed_plan(b, buckets.shape[2], rows // t, d, aligned))


def launch_probed(q: torch.Tensor, pages: torch.Tensor, slots_flat: torch.Tensor,
                  buckets: torch.Tensor, plan: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bucket-major kernel with ``plan`` (``probed_plan``,
    ``dense_plan`` or ``SPARSE_PLAN``) on CUDA tensors that
    ``reuse_top1_probed`` accepts, and count the launch."""
    b, d = q.shape
    rows, cap = slots_flat.shape
    offsets, probers = probe_inversion(buckets, rows // buckets.shape[1])
    n_pages, page_size = (pages.shape[0], pages.shape[1]) if pages.dim() == 3 \
        else (pages.shape[0], 1)
    keys = torch.zeros(b, dtype=torch.int64, device=q.device)
    val = torch.empty(b, dtype=torch.float32, device=q.device)
    idx = torch.empty(b, dtype=torch.int32, device=q.device)
    build.launch("reuse_probed", "reuse_probed_launch", q.device, q.data_ptr(),
                 pages.data_ptr(), slots_flat.data_ptr(), offsets.data_ptr(),
                 probers.data_ptr(), keys.data_ptr(), val.data_ptr(), idx.data_ptr(), b, d,
                 # torch-lint: waive=T002(probed_plan's entries are Python values)
                 rows, cap, n_pages, page_size, int(plan["sparse"]), plan["smem_bytes"])
    LAUNCHES["reuse_top1_probed"] += 1
    return val, idx


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
    return launch_gather("gather_top1_launch", q, store, cand_ids)


# sim_top1: 256 threads score a tile of q_rows queries x 128 store rows,
# walked in chunks of 32 along D (``csrc/sim_topk.cu``)
SIM_Q_ROWS = (16, 32, 64, 128)     # query tiles the kernel is compiled for
SIM_TILE_ROWS, SIM_CHUNK_D = 128, 32
SIM_MIN_SPLIT_ROWS = 1024          # store rows a split, at least
SIM_WAVE_FILL = 0.95               # share of the last wave's block slots filled


def sim_smem(q_rows: int, d: int) -> int:
    """Dynamic shared memory of a sim_top1 block: the query tile d-major and
    two stages of a 32 x 128 store chunk, rows padded by 4 floats.  (The
    block adds q_rows floats of static shared memory: each query's running
    best score.)"""
    return 4 * (d * (q_rows + 4) + 2 * SIM_CHUNK_D * (SIM_TILE_ROWS + 4))


def sim_plan(q: int, n: int, d: int) -> dict:
    """Blocks of the sim_top1 kernel for Q queries over N valid rows of width
    D.  The query tile is the smallest compiled one that holds Q (128 from
    Q > 64), halved while it does not fit in shared memory.  Splits of the
    rows (of at least SIM_MIN_SPLIT_ROWS, whole 128-row tiles) are chosen so
    that query tiles x splits fill the card's block slots (two blocks an SM
    where shared memory allows) in whole waves: the fewest splits that give
    at least one wave with the last one SIM_WAVE_FILL full.  Raises where
    even a 16-query tile does not fit."""
    q_rows = next((r for r in SIM_Q_ROWS if r >= q), SIM_Q_ROWS[-1])
    while sim_smem(q_rows, d) + 4 * q_rows > build.SMEM_LIMIT and q_rows > SIM_Q_ROWS[0]:
        q_rows //= 2
    smem = sim_smem(q_rows, d)
    if smem + 4 * q_rows > build.SMEM_LIMIT:
        raise ValueError(f"D={d} is too wide for the sim_top1 kernel's shared memory")
    q_tiles = max(1, -(-q // q_rows))
    # block slots an SM: static and dynamic shared memory, 1 KB reserved a block
    slots = SMS * max(1, min(2, SM_SMEM // (smem + 4 * q_rows + 1024)))
    n = max(n, 1)
    max_splits = max(1, -(-n // SIM_MIN_SPLIT_ROWS))
    splits = min(max(1, -(-slots // q_tiles)), max_splits)
    while splits < max_splits:
        blocks = q_tiles * splits
        if blocks >= slots and blocks / (-(-blocks // slots) * slots) >= SIM_WAVE_FILL:
            break
        splits += 1
    chunk = -(-(-(-n // splits)) // SIM_TILE_ROWS) * SIM_TILE_ROWS
    splits = -(-n // chunk)
    return {"q_rows": q_rows, "q_tiles": q_tiles, "splits": splits, "chunk": chunk,
            "smem_bytes": smem, "blocks": q_tiles * splits, "slots": slots}


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
    # torch-lint: waive=T002(a tensor n_valid is read on the host by design; callers pass an int)
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
    # the kernel reads q and the store in 4-element vectors
    q, store = (x if _aligned(x, to=4 * x.element_size()) else x.clone() for x in (q, store))
    plan = sim_plan(n_q, n, d)
    keys = torch.empty(n_q, dtype=torch.int64, device=q.device)
    val = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    build.launch("sim_topk", "sim_top1_launch", q.device, q.data_ptr(), store.data_ptr(),
                 keys.data_ptr(), val.data_ptr(), idx.data_ptr(), n_q, d, n, plan["q_rows"],
                 plan["splits"], plan["chunk"], plan["smem_bytes"],
                 int(q.dtype == torch.bfloat16))
    LAUNCHES["sim_top1"] += 1
    return val, idx
