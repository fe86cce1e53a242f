"""Wrapper of the prefill attention kernel (``csrc/flash_attention.cu``).

Port of the Pallas kernel ``repro/kernels/flash_attention.py::flash_attention``.
For a CUDA tensor the wrapper checks its inputs, allocates the output,
launches the hand-written kernel on the current stream and counts the
launch; for a CPU tensor it runs the plain version ``ref.flash_attention_ref``.
There is no fallback: a CUDA input either launches the kernel or raises.

The kernel source has two routes, picked by ``launch_plan`` from the dtype:
bf16 runs on the tensor cores (``wgmma`` fed by TMA), f32 on the CUDA cores
(a tensor-core product would be TF32).  The bf16 route's launch shape, TMA
boxes, swizzle and strides are computed here, where the CPU tests reach
them, and handed to the kernel, which checks them against what it was
compiled for.

Gradients: when any of q, k, v requires grad, the wrapper goes through
``FlashAttention`` (a ``torch.autograd.Function``).  Its forward launches
the same kernel with a per-row log-sum-exp output; its backward launches
the three entry points of ``csrc/flash_attention_bwd.cu`` (delta, dK/dV,
dQ; bf16 on the tensor cores, f32 on the CUDA cores, as
``bwd_launch_plan`` picks) for CUDA tensors and runs
``ref.flash_attention_bwd_ref`` for CPU tensors.  The reference has no
Pallas backward: it differentiates the same attention math with
``jax.grad``.  Without grad the call is the plain kernel launch above.

FakeTensors (a dry run) take neither route: ``forward`` and ``backward``
allocate what the kernels allocate (out and lse; delta and the gradients),
launch nothing, count no launch, and record the kernels' work
(``forward_work``, ``backward_work``: the visible (row, key) pairs they
compute, not the masked ones) through ``build.record_work``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import build, ref

#: launches of the kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd_delta": 0,
            "flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0}

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)   # the kernel's compiled head widths
DTYPES = (torch.float32, torch.bfloat16)

# bf16 route: two consumer warpgroups of 64 rows and 64-key tiles at every
# width.  The kernel is compiled for these (``csrc/flash_attention.cu::
# tc::Cfg``) and refuses a plan that differs.  D=96 and 112 are not whole
# 64-column chunks: their smem tiles are 128 columns wide (the plan's
# ``tile_width``), TMA fills the columns past D with zeros, the S product
# skips the zero k16 steps, P V runs at width 128 and the store writes only
# the first D columns.  D=256 (TC_WIDE: a warpgroup's accumulator is 128
# registers a thread) has no producer warpgroup (the consumers issue the
# loads), so that the block's 256 threads get up to 255 registers each, and
# a flat grid that starts the longest causal tiles of every (kv head,
# batch) first.
TC_ROWS, TC_WARPGROUPS, TC_KEY_TILE, TC_STAGES = 64, 2, 64, 2
TC_WIDE = (256,)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(dtype: torch.dtype, B: int, S: int, T: int, H: int, KV: int,
                D: int) -> dict:
    """The kernel's route and, on the bf16 route, its launch shape.

    ``route`` is "wgmma" (bf16, tensor cores) or "fma" (f32, CUDA cores).
    A row is one (position, group head) pair, ``row = position * G + head``.
    On the wgmma route every value below is handed to the kernel, which
    builds its TMA tensor maps from them and checks them against what it was
    compiled for: a block of ``threads`` runs ``warpgroups`` consumer
    warpgroups of ``q_box[2]`` whole positions each (q_box[2] * G of their 64
    accumulator rows) and a ring of ``stages`` K/V tiles of ``key_tile``
    keys; ``q_box`` and ``kv_box`` are the TMA boxes over (D, heads,
    positions, batch), one ``chunk`` of D columns at a time, swizzled over
    ``swizzle_bytes``; ``grid`` is (blocks along S, KV, B), or at the wide
    widths (TC_WIDE) one axis of (blocks along S) * KV * B blocks whose block
    x takes tile ``tiles - 1 - x // (KV * B)``, kv head ``x % (KV * B) %
    KV`` and batch ``x % (KV * B) // KV``."""
    if dtype not in DTYPES:
        raise TypeError(f"no kernel route for {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} not compiled; the kernel takes {HEAD_DIMS}")
    if dtype == torch.float32:
        return {"route": "fma"}
    G = H // KV
    if G > TC_ROWS:
        raise ValueError(f"{G} query heads per kv head: the bf16 kernel takes at most "
                         f"{TC_ROWS}")
    wg, bn, chunk = TC_WARPGROUPS, TC_KEY_TILE, min(D, 64)
    pos = TC_ROWS // G
    tiles = _cdiv(S, wg * pos)
    wide = D in TC_WIDE
    return {"route": "wgmma", "warpgroups": wg, "threads": 128 * wg + (0 if wide else 128),
            "stages": TC_STAGES, "key_tile": bn, "chunk": chunk,
            "tile_width": _cdiv(D, chunk) * chunk,
            "swizzle_bytes": 2 * chunk, "q_box": (chunk, G, pos, 1),
            "kv_box": (chunk, 1, bn, 1),
            "grid": (tiles * KV * B, 1, 1) if wide else (tiles, KV, B)}


# K6's backward (``csrc/flash_attention_bwd.cu``): bf16 runs on the tensor
# cores, two consumer warpgroups a block and tiles of 64 rows (keys, or
# (position, head) rows) with a two-stage ring; f32 runs on the CUDA cores.
# A warpgroup's accumulator is at most BWD_ACC_COLS columns (ptxas gives a
# thread of a 384-thread block 168 registers; a 64 x 256 fp32 accumulator
# alone is 128): at D=256 each dK/dV block makes one column half of its
# keys' dV and dK (the grid doubles), and the two warpgroups of a dQ block
# share one row tile and make one column half each.  The kernels are
# compiled for these (``tc::Cfg``) and refuse a plan that differs.
BWD_WARPGROUPS, BWD_TILE, BWD_STAGES, BWD_ACC_COLS = 2, 64, 2, 128


def bwd_launch_plan(dtype: torch.dtype, B: int, S: int, T: int, H: int, KV: int,
                    D: int) -> dict:
    """The backward kernels' route and, on the wgmma route, their launch.

    ``route`` is "wgmma" (bf16) or "fma" (f32).  On the wgmma route a block
    of ``threads`` runs ``warpgroups`` consumer warpgroups and a producer;
    every tile is ``tile`` rows of ``tile_width`` columns, loaded as boxes of
    ``chunk`` columns swizzled over ``swizzle_bytes``; a warpgroup's
    accumulator covers ``acc_cols`` of them, one of ``col_halves``.  The
    dK/dV kernel gives each block ``tile`` keys (``kv_box``, loaded once;
    one warpgroup makes their dV, the other their dK, of column half x %
    ``col_halves`` for block x) and walks the query rows that may see them a
    ``q_box`` at a time (``q_box[2]`` whole positions of the kv head's G
    heads, row = position * G + head) through a ring of ``stages`` Q/dO
    tiles: grid ``dkdv_grid`` (key tiles x halves, KV, B).  The dQ kernel
    holds ``q_tiles`` ``q_box`` of rows (loaded once: one a warpgroup, or one
    that both share, each making a column half) and walks their keys a
    ``kv_box`` at a time: grid ``dq_grid`` (position blocks, KV, B)."""
    if dtype not in DTYPES:
        raise TypeError(f"no kernel route for {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} not compiled; the kernel takes {HEAD_DIMS}")
    if dtype == torch.float32:
        return {"route": "fma"}
    G = H // KV
    if G > BWD_TILE:
        raise ValueError(f"{G} query heads per kv head: the bf16 kernels take at most "
                         f"{BWD_TILE}")
    wg, chunk, pos = BWD_WARPGROUPS, min(D, 64), BWD_TILE // G
    width = _cdiv(D, chunk) * chunk
    acc = min(width, BWD_ACC_COLS)
    halves = width // acc
    q_tiles = 1 if halves > 1 else wg
    return {"route": "wgmma", "warpgroups": wg, "threads": 128 * (wg + 1),
            "stages": BWD_STAGES, "tile": BWD_TILE, "chunk": chunk,
            "tile_width": width, "acc_cols": acc, "col_halves": halves,
            "q_tiles": q_tiles, "swizzle_bytes": 2 * chunk,
            "q_box": (chunk, G, pos, 1), "kv_box": (chunk, 1, BWD_TILE, 1),
            "dkdv_grid": (_cdiv(T, BWD_TILE) * halves, KV, B),
            "dq_grid": (_cdiv(S, q_tiles * pos), KV, B)}


def bwd_launch_args(plan: dict, kernel: str) -> Tuple[int, ...]:
    """The plan as ``flash_attention_bwd_{kernel}_launch`` takes it
    (``kernel`` "dkdv" or "dq"): the route (1 wgmma, 0 fma), warpgroups,
    threads, stages, tile, chunk, swizzle bytes, the q box's heads and
    positions, the kernel's blocks along its grid's first axis (zeros after
    the route on the fma route, which takes none)."""
    if plan["route"] != "wgmma":
        return (0,) * 10
    return (1, plan["warpgroups"], plan["threads"], plan["stages"], plan["tile"],
            plan["chunk"], plan["swizzle_bytes"], plan["q_box"][1], plan["q_box"][2],
            plan[f"{kernel}_grid"][0])


def tc_launch_args(plan: dict) -> Tuple[int, ...]:
    """The plan as ``flash_attention_launch`` takes it: warpgroups, threads,
    stages, key_tile, chunk, swizzle bytes, the q box's heads and positions,
    the blocks along S (zeros on the f32 route, which takes none)."""
    if plan["route"] != "wgmma":
        return (0,) * 9
    return (plan["warpgroups"], plan["threads"], plan["stages"], plan["key_tile"],
            plan["chunk"], plan["swizzle_bytes"], plan["q_box"][1], plan["q_box"][2],
            plan["grid"][0])


def tma_strides(x: torch.Tensor) -> Tuple[int, ...]:
    """Element strides of (b, position, head) for a tensor map over x (a
    (B, L, heads, D) tensor): a stride of an axis of length 1 is never
    stepped, so it is set to the contiguous one; every byte stride must be a
    positive multiple of 16 below 2**40 (TMA's rule), or this raises."""
    B, L, NH, D = x.shape
    natural = (L * NH * D, NH * D, D)
    out = []
    for n, s, nat in zip((B, L, NH), (x.stride(0), x.stride(1), x.stride(2)), natural):
        s = nat if n == 1 else s
        if s <= 0 or (s * x.element_size()) % 16 or s * x.element_size() >= 2 ** 40:
            raise ValueError(f"strides {x.stride()} cannot feed a TMA tensor map "
                             "(positive multiples of 16 bytes)")
        out.append(s)
    return tuple(out)


def visible_pairs(S: int, T: int, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> int:
    """(row, key) pairs of one head the kernels compute: row s, at position
    s + ``q_offset``, sees the keys t < T with t <= s + q_offset (causal) and
    t > s + q_offset - window."""
    pos = np.arange(S, dtype=np.int64) + q_offset
    hi = np.minimum(T - 1, pos) if causal else np.full(S, T - 1, dtype=np.int64)
    lo = np.maximum(0, pos - window + 1) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def forward_work(B: int, S: int, T: int, H: int, KV: int, D: int, elem: int, *,
                 causal: bool = True, window: Optional[int] = None,
                 softcap: Optional[float] = None, q_offset: int = 0,
                 with_lse: bool = False) -> dict:
    """K6's forward on (B, S, H, D) x (B, T, KV, D) inputs of ``elem`` bytes
    an element: 4 D FLOPs a visible pair (q.k and p.v), q, k and v read and
    out written once (lse, f32, with ``with_lse``), an exp a pair (and a tanh
    with a softcap)."""
    pairs = B * H * visible_pairs(S, T, causal, window, q_offset)
    return {"flops": 4.0 * D * pairs,
            "bytes": elem * (2 * B * S * H * D + 2 * B * T * KV * D)
            + (4 * B * H * S if with_lse else 0),
            "transcendental": pairs * (2 if softcap is not None else 1)}


def backward_work(B: int, S: int, T: int, H: int, KV: int, D: int, elem: int, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset: int = 0) -> dict:
    """K6's whole backward: the five products (S again, dP, dV, dQ, dK), 10 D
    FLOPs a visible pair; q, out, dout, k, v and lse read and dq, dk, dv
    written once; an exp a pair (and a tanh with a softcap)."""
    pairs = B * H * visible_pairs(S, T, causal, window, q_offset)
    return {"flops": 10.0 * D * pairs,
            "bytes": elem * (4 * B * S * H * D + 4 * B * T * KV * D) + 4 * B * H * S,
            "transcendental": pairs * (2 if softcap is not None else 1)}


def check_vector_rows(name: str, x: torch.Tensor) -> None:
    """The kernels read rows 16 bytes at a time: the last axis contiguous,
    every other stride and the base 16-byte aligned (a FakeTensor has no
    base to check)."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) != 1 or any(s % per16 for s in x.stride()[:-1])
            or (not build.is_fake(x) and x.data_ptr() % 16)):
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned "
                         f"(strides {x.stride()})")


def check_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_dims: int) -> None:
    """Shapes, dtypes and devices shared by the two attention wrappers."""
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or (KV == 0) != (H == 0) or (KV and H % KV):
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)} "
                         "(same batch and head width, H a multiple of KV; no kv head "
                         "for no q head)")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError("q, k, v must be float32 or bfloat16 (k and v alike)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """GQA prefill attention: q (B, S, H, D), k/v (B, T, KV, D) -> (B, S, H,
    D) in q's dtype, fp32 inside.  Row s of q is position s + ``q_offset``
    (the absolute position of q[0]: a chunk of a longer prompt whose keys
    are k[:, :T]); ``causal`` masks t > s + q_offset, ``window`` masks t <=
    s + q_offset - window, ``softcap`` caps logits at c*tanh(s/c),
    ``scale`` defaults to 1/sqrt(D).  q, k, v share one dtype.
    Differentiable in q, k and v (``FlashAttention``)."""
    check_attention(q, k, v, 4)
    if q.dtype != k.dtype:
        raise TypeError("q, k and v must share one dtype")
    if window is not None and window < 1:
        raise ValueError("window must be a positive number of positions")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    if q_offset < 0:
        raise ValueError("q_offset is a position: it cannot be negative")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale, int(q_offset))
    return forward(q, k, v, causal, window, softcap, scale, q_offset=int(q_offset))


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], softcap: Optional[float], scale: float,
            with_lse: bool = False, q_offset: int = 0):
    """The checked call: out, and with ``with_lse`` (out, lse (B, H, S) fp32,
    +inf for a row that sees no key).  CPU tensors run the plain version.
    No q head (H = 0, a rank of "model" without heads): empty results,
    nothing launched or recorded."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if H == 0:
        out = q.new_empty((B, S, 0, D))
        return (out, q.new_empty((B, 0, S), dtype=torch.float32)) if with_lse else out
    if build.is_fake(q, k, v):
        launch_plan(q.dtype, B, S, T, H, KV, D)      # the dtype and width checks
        out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
        build.record_work("flash_attention", forward_work(
            B, S, T, H, KV, D, q.element_size(), causal=causal, window=window,
            softcap=softcap, q_offset=q_offset, with_lse=with_lse))
        return (out, lse) if with_lse else out
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale, return_lse=with_lse,
                                       q_offset=q_offset)
    plan = launch_plan(q.dtype, B, S, T, H, KV, D)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_vector_rows(name, x)
    tc = plan["route"] == "wgmma"
    st = [s for x in (q, k, v) for s in (tma_strides(x) if tc else x.stride()[:3])]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = None
    if with_lse:   # T = 0: the bf16 route zeroes out without a launch, writes no lse
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        if T == 0:
            lse.fill_(torch.inf)
    build.launch(
        "flash_attention", "flash_attention_launch", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, S, T, H, KV, D, *st, int(causal), -1 if window is None else int(window),
        int(q_offset), -1.0 if softcap is None else float(softcap), scale, int(tc),
        *tc_launch_args(plan))
    LAUNCHES["flash_attention"] += 1
    if build.observing():
        build.record_work("flash_attention", forward_work(
            B, S, T, H, KV, D, q.element_size(), causal=causal, window=window,
            softcap=softcap, q_offset=q_offset, with_lse=with_lse))
    return (out, lse) if with_lse else out


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
             lse: torch.Tensor, dout: torch.Tensor, causal: bool, window: Optional[int],
             softcap: Optional[float], scale: float, q_offset: int = 0):
    """(dq, dk, dv) in q's dtype: ``ref.flash_attention_bwd_ref`` for CPU
    tensors; for CUDA tensors the three kernels of
    ``csrc/flash_attention_bwd.cu`` on contiguous copies of the inputs, on
    the route ``bwd_launch_plan`` picks: delta = rowsum(dO * O) (B, H, S),
    then dK and dV (a block per key tile, kv head and batch, over every
    query row of the kv head's G heads: no atomics), then dQ (a block per
    row block), each counted in ``LAUNCHES``.  Deterministic: the same
    inputs give the same bits.  FakeTensors allocate what the CUDA route
    does (contiguous copies of the inputs that are not, delta, the three
    gradients) and record ``backward_work``.  No q head (H = 0): empty
    gradients, no launch, no work."""
    if q.shape[2] == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if build.is_fake(q, k, v, out, lse, dout):
        B, S, H, D = q.shape
        T, KV = k.shape[1], k.shape[2]
        q, k, v, out, dout = (x.contiguous() for x in (q, k, v, out, dout.to(q.dtype)))
        bwd_launch_plan(q.dtype, B, S, T, H, KV, D)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)  # noqa: F841
        build.record_work("flash_attention_bwd", backward_work(
            B, S, T, H, KV, D, q.element_size(), causal=causal, window=window,
            softcap=softcap, q_offset=q_offset))
        return dq, dk, dv
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                           window=window, softcap=softcap, scale=scale,
                                           q_offset=q_offset)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    q, k, v, out, dout = (x.contiguous() for x in (q, k, v, out, dout.to(q.dtype)))
    plan = bwd_launch_plan(q.dtype, B, S, T, H, KV, D)   # also the dtype and width checks
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B * S == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    masks = (int(causal), -1 if window is None else int(window), int(q_offset),
             -1.0 if softcap is None else float(softcap), scale)
    build.launch("flash_attention_bwd", "flash_attention_bwd_delta_launch", q.device,
                 out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B * S * H, D, S, H, bf16)
    LAUNCHES["flash_attention_bwd_delta"] += 1
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    build.launch("flash_attention_bwd", "flash_attention_bwd_dkdv_launch", q.device,
                 *ptrs, dk.data_ptr(), dv.data_ptr(), B, S, T, H, KV, D, *masks, bf16,
                 *bwd_launch_args(plan, "dkdv"))
    LAUNCHES["flash_attention_bwd_dkdv"] += 1
    build.launch("flash_attention_bwd", "flash_attention_bwd_dq_launch", q.device,
                 *ptrs, dq.data_ptr(), B, S, T, H, KV, D, *masks, bf16,
                 *bwd_launch_args(plan, "dq"))
    LAUNCHES["flash_attention_bwd_dq"] += 1
    if build.observing():
        build.record_work("flash_attention_bwd", backward_work(
            B, S, T, H, KV, D, q.element_size(), causal=causal, window=window,
            softcap=softcap, q_offset=q_offset))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K6 with its gradient: the forward kernel with lse, saved with q, k, v
    and out; the backward kernels on dO.  Arguments as ``forward``'s; the
    masks and ``q_offset`` are not tensors and take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        out, lse = forward(q, k, v, causal, window, softcap, scale, with_lse=True,
                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, softcap, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, dout, *ctx.masks)
        return dq, dk, dv, None, None, None, None, None
