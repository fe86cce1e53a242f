"""Wrappers of the fused normalisation and rotary kernels (``csrc/norm_rope.cu``).

No TPU kernel is replaced: the JAX package leaves RMSNorm, the q/k bias,
the qk-norm and the rotary embedding to XLA, which fuses them on the TPU.
On the card each was a chain of float32 passes; ``rms_norm`` and
``qk_rope`` do each site in one pass over bf16 rows.  For a CUDA tensor a
wrapper checks its inputs, launches its kernel on the current stream and
counts the launch; for a CPU tensor it runs the plain version in ``ref.py``.
There is no fallback: a CUDA input either launches the kernel or raises.
Which tensors the model hands to these wrappers at all is decided by
``ops.norm_engages`` and ``ops.rope_engages`` (bf16 on the card, no
DTensor, nothing that requires grad); fake tensors never get here.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build, ref

#: launches of each kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"rms_norm": 0, "qk_rope": 0}

VEC = 8                  # bf16 values in a 16-byte vector
MAX_THREADS = 512        # threads of a norm block that takes a whole row
MAX_VEC_PER_LANE = 8     # 16-byte vectors a norm lane holds in registers
NORM_MAX_D = MAX_THREADS * MAX_VEC_PER_LANE * VEC
ROPE_MAX_D = 512         # the kernel's shared angles hold D / 2 <= 256
ROPE_THREADS = 512       # at most, a block (a token) of the rotary kernel


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def norm_plan(d: int) -> dict:
    """The norm kernel's layout for rows of ``d`` values: ``lanes`` threads
    a row, each holding ``vec_per_lane`` 16-byte vectors.  Rows of at most
    32 vectors (head rows) take the next power of two of lanes inside a
    warp, several rows to a block of 256 threads; wider rows a block each,
    the fewest vectors a lane (1, 2, 4 or 8) that keep the block at
    ``MAX_THREADS`` threads or fewer, rounded up to whole warps."""
    if d % VEC or not 0 < d <= NORM_MAX_D:
        raise ValueError(f"rows of {d}: the norm kernel takes multiples of 8 up to {NORM_MAX_D}")
    nvec = d // VEC
    if nvec <= 32:
        lanes = _pow2_at_least(nvec)
        return {"lanes": lanes, "vec_per_lane": 1, "threads": 256}
    kv = next(v for v in (1, 2, 4, 8) if -(-nvec // v) <= MAX_THREADS)
    threads = -(-(-(-nvec // kv)) // 32) * 32     # ceil(nvec / kv), in whole warps
    return {"lanes": threads, "vec_per_lane": kv, "threads": threads}


def rope_plan(D: int, n_heads: int) -> dict:
    """The rotary kernel's layout for heads of ``D`` and ``n_heads`` (q and
    k) rows a token: a lane takes 8 values of each half, a row the next
    power of two of D / 16 lanes; a block (a token) takes every row at once
    up to ``ROPE_THREADS`` threads, then walks them in turns."""
    if D % (2 * VEC) or not 0 < D <= ROPE_MAX_D:
        raise ValueError(f"head width {D}: the rotary kernel takes multiples of 16 up to "
                         f"{ROPE_MAX_D}")
    lanes = _pow2_at_least(D // (2 * VEC))
    threads = min(-(-n_heads * lanes // 32) * 32, ROPE_THREADS)
    return {"lanes": lanes, "threads": threads}


_norm_plan = functools.lru_cache(maxsize=64)(norm_plan)
_rope_plan = functools.lru_cache(maxsize=64)(rope_plan)


def _rows16(t: torch.Tensor) -> bool:
    """Contiguous, on a 16-byte boundary: the kernels' vector rows."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def norm_takes(x: torch.Tensor, scale: torch.Tensor,
               residual: Optional[torch.Tensor] = None) -> bool:
    """Whether the norm kernel takes these rows (x's dtype and the device
    aside): a width that is a multiple of 8 up to ``NORM_MAX_D``, contiguous
    16-byte aligned rows, a float32 (d,) scale, a residual of x's shape and
    dtype."""
    d = x.shape[-1] if x.dim() else 0
    return (d % VEC == 0 and 0 < d <= NORM_MAX_D and _rows16(x) and scale.shape == (d,)
            and scale.dtype == torch.float32 and _rows16(scale) and (residual is None or (
                residual.shape == x.shape and residual.dtype == x.dtype and _rows16(residual))))


def rope_takes(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor) -> bool:
    """Whether the rotary kernel takes q (B, S, H, D) and k (B, S, KV, D)
    (dtype and device aside): one head width, a multiple of 16 up to
    ``ROPE_MAX_D``, contiguous 16-byte aligned rows, int64 positions of at
    most two dims."""
    D = q.shape[-1]
    return (q.dim() == k.dim() == 4 and q.shape[:2] == k.shape[:2] and k.shape[-1] == D
            and D % (2 * VEC) == 0 and 0 < D <= ROPE_MAX_D and _rows16(q) and _rows16(k)
            and positions.dtype == torch.int64 and positions.dim() <= 2)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(*ts) -> None:
    dev = ts[0].device
    for t in ts:
        if t is not None and t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, not {t.device}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             residual: Optional[torch.Tensor] = None):
    """RMSNorm of x's rows (the last dim) with the (1 + scale)
    parameterisation, in x's dtype.  With ``residual``, the rows are first
    ``residual + x`` rounded to x's dtype, and the result is (normed, sum).
    On the card: one launch, bf16 rows, a float32 scale."""
    if x.device.type == "cpu":
        return ref.rms_norm_ref(x, scale, eps, residual)
    _check_cuda(x, scale, residual)
    if x.dtype != torch.bfloat16 or scale.dtype != torch.float32:
        raise TypeError(f"the norm kernel takes bf16 rows and a float32 scale, not {x.dtype} "
                        f"and {scale.dtype}")
    if not norm_takes(x, scale, residual):
        raise ValueError(f"the norm kernel does not take rows {tuple(x.shape)} with scale "
                         f"{tuple(scale.shape)} (multiples of 8 up to {NORM_MAX_D}, contiguous "
                         f"16-byte aligned rows)")
    y = torch.empty_like(x)
    total = torch.empty_like(x) if residual is not None else None
    rows = x.numel() // x.shape[-1]
    if rows:
        plan = _norm_plan(x.shape[-1])
        build.launch("norm_rope", "rms_norm_launch", x.device, x.data_ptr(),
                     _ptr(residual), scale.data_ptr(), y.data_ptr(), _ptr(total), rows,
                     x.shape[-1], plan["lanes"], plan["threads"], plan["vec_per_lane"],
                     float(eps))
        LAUNCHES["rms_norm"] += 1
    return y if residual is None else (y, total)


@functools.lru_cache(maxsize=16)
def inv_freq(D: int, theta: float, device: torch.device) -> torch.Tensor:
    """``ref.rope_freqs(D, theta)`` on ``device``, computed once: the same
    float32 values the plain rotation computes on every call."""
    return ref.rope_freqs(D, theta, device)


def _pos_strides(positions: torch.Tensor, B: int, S: int) -> Tuple[int, int]:
    """Element strides of positions over (batch, sequence), 0 where it
    broadcasts: (S,), (1, S), (B, S), (B, 1) or (1, 1)."""
    shape = (1,) * (2 - positions.dim()) + tuple(positions.shape)
    strides = (0,) * (2 - positions.dim()) + tuple(positions.stride())
    if any(n not in (1, want) for n, want in zip(shape, (B, S))):
        raise ValueError(f"positions {tuple(positions.shape)} do not broadcast to ({B}, {S})")
    return tuple(0 if n == 1 else st for n, st in zip(shape, strides))


def qk_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float, *,
            q_norm: Optional[torch.Tensor] = None, k_norm: Optional[torch.Tensor] = None,
            bq: Optional[torch.Tensor] = None, bk: Optional[torch.Tensor] = None,
            eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, D) and k (B, S, KV, D) as attention takes them: each
    plus its bias (``bq`` (H * D,), ``bk``; rounded to the activation
    dtype), RMSNorm'd per head (``q_norm``, ``k_norm`` (D,)), then rotated
    by split halves at angles ``positions`` x ``inv_freq(D, theta)``;
    ``positions`` broadcasts to (B, S) ((1, S) in a prefill, (B, 1) in a
    decode step).  On the card one launch for q and k together, which
    writes the results into q and k in place and returns them: the
    projections' outputs, which nothing else reads.  On the CPU the plain
    chain, into new tensors."""
    if q.device.type == "cpu":
        return ref.qk_rope_ref(q, k, positions, theta, q_norm=q_norm, k_norm=k_norm,
                               bq=bq, bk=bk, eps=eps)
    _check_cuda(q, k, positions, q_norm, k_norm, bq, bk)
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"the rotary kernel takes bf16 q and k, not {q.dtype} and {k.dtype}")
    if not rope_takes(q, k, positions):
        raise ValueError(f"the rotary kernel does not take q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, positions {tuple(positions.shape)} "
                         f"{positions.dtype}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    for name, t, n in (("q_norm", q_norm, D), ("k_norm", k_norm, D), ("bq", bq, H * D),
                       ("bk", bk, KV * D)):
        want = torch.float32 if name.endswith("norm") else torch.bfloat16
        if t is not None and (t.shape != (n,) or t.dtype != want or not _rows16(t)):
            raise ValueError(f"{name} must be a contiguous ({n},) {want} tensor")
    sb, ss = _pos_strides(positions, B, S)
    if B * S:
        plan = _rope_plan(D, H + KV)
        build.launch("norm_rope", "qk_rope_launch", q.device, q.data_ptr(), k.data_ptr(),
                     positions.data_ptr(), sb, ss, inv_freq(D, float(theta), q.device).data_ptr(),
                     _ptr(bq), _ptr(bk), _ptr(q_norm), _ptr(k_norm), B * S, S, H, KV, D,
                     plan["lanes"], plan["threads"], float(eps))
        LAUNCHES["qk_rope"] += 1
    return q, k
