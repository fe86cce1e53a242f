"""Public wrappers around the kernels: padding, dispatch, launch counters.

Port of ``repro/kernels/ops.py`` for the ported kernels.  Every op runs its
hand-written CUDA kernel for CUDA tensors and the kernel's plain version
(``ref.py``) for CPU tensors; the choice follows the device of the tensors
the caller passes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import fp32_matmul
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import lsh_hash as _lsh
from . import norm_rope as _norm
from . import sim_topk as _topk
from .fused_query import fused_query as _fused_query

# Calls of the fused query pipeline (one ``reuse_top1_probed`` launch each).
FUSED_DISPATCH_COUNT = 0


_COUNTERS = (_topk.LAUNCHES, _lsh.LAUNCHES, _flash.LAUNCHES, _decode.LAUNCHES,
             _norm.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def _pad_rows(x: torch.Tensor, mult: int) -> torch.Tensor:
    n = x.shape[0]
    target = -(-n // mult) * mult
    if target == n:
        return x
    return torch.cat([x, x.new_zeros((target - n,) + tuple(x.shape[1:]))])


# ------------------------------------------------------------------- lsh_hash
def lsh_hash_ids(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """(B, D) x (T, K, D, D) -> (B, T, K) int32 cross-polytope vertex ids."""
    return _lsh.lsh_hash(x, rotations)


def lsh_buckets(x: torch.Tensor, rotations: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Hash + per-table bucket mixing in one launch -> (B, T) int32."""
    return _lsh.lsh_hash_mix(x, rotations, num_buckets)


# ------------------------------------------------------------------- sim_topk
def similarity_scores(q: torch.Tensor, store: torch.Tensor) -> torch.Tensor:
    """Dense cosine scores q (Q, D) x store (N, D) -> (Q, N) f32: a plain
    matmul at full fp32, as the reference leaves it outside any kernel."""
    qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sn = store / store.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    with fp32_matmul():
        return qn @ sn.T


def nearest_neighbor(q: torch.Tensor, store: torch.Tensor,
                     n_valid: Optional[Union[int, torch.Tensor]] = None):
    """Streaming top-1 over a whole (unit-normalised) store: (best (Q,) f32,
    idx (Q,) int32), the first index of the maximum; rows at or after
    ``n_valid`` are masked."""
    return _topk.sim_top1(q, store, n_valid)


def gathered_top1(q: torch.Tensor, store: torch.Tensor, cand_ids: torch.Tensor):
    """Multi-probe gather + masked cosine top-1 (the staged batched query).

    q: (Q, D) unit rows; store: (N, D) or the paged (P, S, D) buffer;
    cand_ids: (Q, C) int32 sorted unique row ids, -1 padded.  Returns (best
    (Q,) f32, idx (Q,) int32), (-inf, -1) for queries without candidates.
    """
    q = torch.atleast_2d(q)
    nq = q.shape[0]
    if store.numel() == 0 or cand_ids.shape[1] == 0:
        return (torch.full((nq,), -torch.inf, device=q.device),
                torch.full((nq,), -1, dtype=torch.int32, device=q.device))
    return _topk.gather_top1(q.contiguous(), store, cand_ids.contiguous())


# --------------------------------------------------------- fused reuse query
def unique_counts(cand: np.ndarray) -> np.ndarray:
    """Exact unique-candidate counts from a raw (B, W) candidate-id matrix,
    on the host: the numpy twin of the fused pipeline's count epilogue."""
    srt = np.sort(cand, axis=1)
    first = np.concatenate(
        [np.ones((srt.shape[0], 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1)
    return ((srt >= 0) & first).sum(axis=1).astype(np.int32)


def reuse_query_top1(embs: torch.Tensor, lsh, slots_dev: torch.Tensor,
                     pages_dev: torch.Tensor, *, gather_mode: str = "take",
                     need_counts: bool = True):
    """One-call batched reuse query over the device-resident store.

    embs: (B, D) unit rows; lsh: the store's ``core.lsh.LSH`` (its params and
    rotation/plane tensors are read); slots_dev: (T * num_buckets,
    bucket_cap) int32 slot tables; pages_dev: paged (num_pages, page_size, D)
    embedding mirror.

    Returns (best (B,) f32, idx (B,) int32, counts) on the store's device:
    idx is a row id (-1 = no candidate, lowest id wins similarity ties);
    counts are the exact unique-candidate statistics, or None when the caller
    passes ``need_counts=False`` (peek reads record no statistics); they come
    from the in-call sort epilogue on every device.  B is padded to a
    multiple of 8.
    """
    global FUSED_DISPATCH_COUNT
    p = lsh.params
    proj = lsh.rotations if p.family == "cross_polytope" else lsh.planes
    x = torch.atleast_2d(embs.to(pages_dev.device, torch.float32))
    nq = x.shape[0]
    val, idx, counts = _fused_query(
        _pad_rows(x, 8).contiguous(), proj, slots_dev, pages_dev,
        family=p.family, num_probes=p.num_probes, gather_mode=gather_mode,
        with_counts=need_counts)
    FUSED_DISPATCH_COUNT += 1
    return val[:nq], idx[:nq], None if counts is None else counts[:nq]


# ------------------------------------------------------------------ attention
def _dtensors(*xs) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in xs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """(B, S, H, D) x (B, T, KV, D)^2 -> (B, S, H, D): prefill attention;
    row s of q is position s + ``q_offset``.  DTensors (under a mesh) run
    K6 on each rank's shards (``sharded_flash_attention``)."""
    kw = {"causal": causal, "window": window, "softcap": softcap, "scale": scale,
          "q_offset": q_offset}
    if _dtensors(q, k, v):
        return sharded_flash_attention(q, k, v, **kw)
    return _flash.flash_attention(q, k, v, **kw)


def head_slice_calls(h0: int, h1: int, G: int) -> list:
    """K6's calls for q heads [h0, h1) of groups of G (head h reads kv head
    h // G): (first kv head, kv heads, q heads) of each.  Whole groups are
    one call; a slice that cuts a group is one call per run of heads inside
    one kv head (at most ceil(hl / G) + 1); no head, no call."""
    if h0 == h1:
        return []
    if h0 % G == 0 and h1 % G == 0:
        return [(h0 // G, h1 // G - h0 // G, h1 - h0)]
    return [(j, 1, min(h1, (j + 1) * G) - max(h0, j * G)) for j in range(h0 // G, -(-h1 // G))]


def head_slice_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h0: int,
                         n_heads: int, **kw) -> torch.Tensor:
    """K6 on a slice of q's heads, the rank-local work of a model axis that
    splits the heads: q (B, S, hl, D) holds heads [h0, h0 + hl) of
    ``n_heads``, k and v (B, T, KV, D) all the kv heads; head h reads kv
    head h // G (G = n_heads // KV).  -> (B, S, hl, D), K6 on exactly these
    heads and the kv heads they read, with ``flash_attention``'s keywords.

    A slice of whole kv groups is one call on its kv heads.  A slice that
    cuts a group (llama4's heads 3, 4, 5 read kv heads 0, 0, 1) makes one
    call per run of heads inside one kv head (``head_slice_calls``), each
    against a view of that kv head: no copy of K or V, and each run's dK
    and dV summed over its heads in the kernel.  An empty slice (hl = 0)
    launches nothing and gives (B, S, 0, D), with a zero gradient for k and
    v."""
    calls = head_slice_calls(h0, h0 + q.shape[2], n_heads // k.shape[2])
    if not calls:
        return _flash.flash_attention(q, k[:, :, :0], v[:, :, :0], **kw)
    outs, at = [], 0
    for j, nk, n in calls:
        outs.append(_flash.flash_attention(q[:, :, at:at + n], k[:, :, j:j + nk],
                                           v[:, :, j:j + nk], **kw))
        at += n
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def sharded_flash_attention(q, k, v, **kw):
    """K6 on DTensors, the counterpart of running the kernel under
    ``shard_map``: q, k, v are redistributed so that the batch splits over
    the batch axes ("pod", "data"; where they divide it) and q's heads over
    "model" in DTensor's chunks (ceil(H / m) a rank, the last ranks fewer
    or none, as the reference's constraint splits them), k and v replicated
    over "model".  Each rank runs ``head_slice_attention`` on its heads
    [h0, h1) and the kv heads they read, and the output carries q's
    placements.  Gradients flow through ``to_local``: a rank's dK and dV
    cover its kv heads only, so over "model" they are partial sums."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..models.partitioning import contiguous_strides, local_shape_and_offset

    if not all(isinstance(x, DTensor) for x in (q, k, v)):
        raise TypeError("q, k and v must all be DTensors, or none")
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    B, H = q.shape[0], q.shape[2]
    batch = [a for a in ("pod", "data") if a in names]
    nb = 1
    for a in batch:
        nb *= mesh.size(names.index(a))
    split_b = B % nb == 0
    qp, kp, kgrad = [], [], []
    for a in names:
        if a in batch and split_b:
            qp.append(Shard(0)), kp.append(Shard(0)), kgrad.append(Shard(0))
        elif a == "model" and mesh.size(names.index(a)) > 1:
            qp.append(Shard(2)), kp.append(Replicate()), kgrad.append(Partial())
        else:
            qp.append(Replicate()), kp.append(Replicate()), kgrad.append(Replicate())
    qp = tuple(qp)
    ql = q.redistribute(mesh, qp).to_local(grad_placements=qp)
    kl = k.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    vl = v.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    h0 = local_shape_and_offset(q.shape, mesh, qp)[1][2]
    out = head_slice_attention(ql, kl, vl, h0, H, **kw)
    return DTensor.from_local(out, mesh, qp, shape=q.shape, stride=contiguous_strides(q.shape))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, D) x (B, T, KV, D)^2 + (B,) -> (B, H, D): one decode step.
    DTensors (under a mesh) run K7 on each rank's cache shard
    (``sharded_decode_attention``)."""
    if _dtensors(q, k, v, kv_len):
        return sharded_decode_attention(q, k, v, kv_len, softcap=softcap, scale=scale)
    return _decode.decode_attention(q, k, v, kv_len, softcap=softcap, scale=scale)


def decode_head_slice(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, h0: int, n_heads: int, **kw):
    """K7 on a slice of q's heads, the rank-local work of batch axes that
    split the heads: q (B, hl, D) holds heads [h0, h0 + hl) of ``n_heads``,
    k and v (B, T, KV, D) every kv head; head h reads kv head h // G (G =
    n_heads // KV).  One call per ``head_slice_calls`` entry (one for a slice
    of whole kv groups), each against a strided view of its kv heads (no
    copy of the cache), with ``decode_attention``'s keywords; outputs (and
    with ``return_lse`` the lse) concatenated over the heads.  An empty
    slice launches nothing and gives (B, 0, D) (and (B, 0))."""
    calls = head_slice_calls(h0, h0 + q.shape[1], n_heads // k.shape[2])
    lse = kw.get("return_lse", False)
    if not calls:
        out = q.new_zeros((q.shape[0], 0, q.shape[2]))
        return (out, out.new_zeros((q.shape[0], 0), dtype=torch.float32)) if lse else out
    outs, at = [], 0
    for j, nk, n in calls:
        outs.append(_decode.decode_attention(q[:, at:at + n], k[:, :, j:j + nk],
                                             v[:, :, j:j + nk], kv_len, **kw))
        at += n
    if len(outs) == 1:
        return outs[0]
    if lse:
        return torch.cat([o for o, _ in outs], dim=1), torch.cat([s_ for _, s_ in outs], dim=1)
    return torch.cat(outs, dim=1)


def sharded_decode_attention(q, k, v, kv_len, *, softcap: Optional[float] = None,
                             scale: Optional[float] = None):
    """K7 on a DTensor cache sharded over its batch (dim 0) and, for context
    parallelism, its sequence (dim 1), without gathering the cache: the
    counterpart of the reference's decode under ``cache_shardings``.

    q is redistributed to the cache's batch split and replicated over the
    other mesh axes.  Each rank takes its local cache shard, slots [t0, t0 +
    Tl) of rows [b0, b0 + Bl) (DTensor's chunks: where T does not divide
    over the sequence axes the shards are uneven and each rank takes its own
    Tl and t0, an empty one Tl = 0), counts its valid slots kv_len_r =
    clamp(kv_len - t0, 0, Tl) and runs K7 with ``return_lse`` on q in f32,
    so that the partial outputs it combines are f32.  Over the sequence
    axes the shards' partial softmaxes are merged by their log-sum-exps
    (``decode_attention.combine``): M = max_r lse_r (an all-reduce), w_r =
    exp(lse_r - M) (0 where lse_r is -inf: a shard with no valid slot), out
    = sum_r w_r out_r / sum_r w_r (the two sums in one all-reduce); a row
    whose shards are all empty gives 0, as K7 does.

    Where the batch axes ("pod", "data") leave the cache's batch whole (a
    batch of 1 on 16 data ranks) and their n ranks divide the kv heads, they
    split the heads instead, as the reference's compiled decode does
    (zamba2's 32 kv heads, seamless's 16): each rank takes KV / n whole kv
    groups and their q heads (DTensor's chunks over those axes) and runs K7
    on them (``decode_head_slice``: strided views of its cache shard),
    merges over the sequence axes on its heads only, and the heads are
    gathered over the batch axes (B x H x D values).  Where "pod" and
    "data" together do not divide the kv heads, "data" alone splits them;
    fewer kv heads than data ranks (qwen3's 8, gemma-2b's 1 over 16) keep
    every head on every rank, as the reference does: a cut group would make
    several ranks read one kv head's slots.  The output is q's dtype with the cache's batch
    placement.  ``kv_len`` is a plain (B,) tensor (the same on every rank)
    or a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..models.partitioning import contiguous_strides, local_shape_and_offset

    if not all(isinstance(x, DTensor) for x in (q, k, v)):
        raise TypeError("q, k and v must all be DTensors, or none")
    mesh = k.device_mesh
    names = mesh.mesh_dim_names or ()
    if tuple(v.placements) != tuple(k.placements):
        raise ValueError(f"k and v are placed differently: {k.placements}, {v.placements}")
    qp, seq_dims, head_dims = [], [], []
    for i, p in enumerate(k.placements):
        if isinstance(p, Shard) and p.dim in (1, -3):
            seq_dims.append(i)
            qp.append(Replicate())
        elif isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim in (0, -4)):
            qp.append(Shard(0) if isinstance(p, Shard) else Replicate())
            if isinstance(p, Replicate) and names[i] in ("pod", "data") and mesh.size(i) > 1:
                head_dims.append(i)
        else:
            raise ValueError(f"K7 takes a cache sharded over its batch or sequence dim, "
                             f"not {tuple(k.placements)}")
    qp = tuple(qp)
    while head_dims and k.shape[2] % math.prod(mesh.size(i) for i in head_dims):
        head_dims = head_dims[1:]       # "pod" first: split over "data" alone
    B, H = q.shape[0], q.shape[1]
    (Bl, Tl, _, _), (b0, t0, _, _) = local_shape_and_offset(k.shape, mesh, k.placements)
    ql = q.redistribute(mesh, qp).to_local()
    kl, vl = k.to_local(), v.to_local()
    if isinstance(kv_len, DTensor):
        lens = kv_len.redistribute(mesh, qp).to_local()
    else:
        lens = kv_len[b0:b0 + Bl]
    # the rank's heads: all, or its chunk over the batch axes that split them
    hp = tuple(Shard(1) if i in head_dims else p for i, p in enumerate(qp))
    (_, hl, _), (_, h0, _) = local_shape_and_offset(q.shape, mesh, hp)
    ql = ql[:, h0:h0 + hl]

    def global_(x: torch.Tensor, placed) -> torch.Tensor:
        shape = (B, H) + tuple(x.shape[2:])
        return DTensor.from_local(x, mesh, placed, shape=shape,
                                  stride=contiguous_strides(shape))

    def attend(*args, **kw):
        return decode_head_slice(*args, h0, H, softcap=softcap, scale=scale, **kw)

    if not seq_dims:
        out = attend(ql, kl, vl, lens)
    else:
        lens = (lens - t0).clamp(0, Tl).to(torch.int32)
        out_r, lse_r = attend(ql.float(), kl, vl, lens, return_lse=True)
        if hl:   # a rank without heads: so are the others of its sequence group
            out = _decode.combine(out_r, lse_r, lambda x: _seq_reduce(x, "max", mesh, seq_dims),
                                  lambda x: _seq_reduce(x, "sum", mesh, seq_dims))
        else:
            out = out_r
        out = out.to(q.dtype)
    if head_dims:
        return global_(out, hp).redistribute(mesh, qp)
    return global_(out, qp)


def _seq_reduce(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``x`` reduced by ``op`` ("sum" or "max") over the mesh dims ``dims``
    (all-reduces over each)."""
    import torch.distributed._functional_collectives as funcol

    for i in dims:
        if mesh.size(i) > 1:
            x = funcol.all_reduce(x.contiguous(), op, (mesh, i))
            if isinstance(x, funcol.AsyncCollectiveTensor):
                x = x.wait()
    return x


# ---------------------------------------------------------- norms and rotary
_PLAIN = (torch.Tensor, torch.nn.Parameter)   # a DTensor's or a fake tensor's type is neither


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _plain_bf16(x: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """x in bf16; x and each other tensor given plain (no DTensor, no fake
    tensor), on x's device, and not requiring grad."""
    return x.dtype == torch.bfloat16 and all(
        type(t) in _PLAIN and not t.requires_grad and t.device == x.device
        for t in (x, *others) if t is not None)


def norm_engages(x: torch.Tensor, scale: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> bool:
    """Whether a norm site runs the fused kernel (``rms_norm``): bf16 rows
    on the card, plain tensors, none requiring grad (a served model's
    frozen parameters; training's float32 masters do), rows the kernel
    takes.  Every other case keeps the plain float32 chain."""
    return _on_card(x) and _plain_bf16(x, scale, residual) and _norm.norm_takes(x, scale,
                                                                                 residual)


def rope_engages(x: torch.Tensor, positions: torch.Tensor, head_dim: int,
                 *params: Optional[torch.Tensor]) -> bool:
    """Whether self-attention's q and k run the fused bias, qk-norm and
    rotation (``qk_rope``), decided on the projections' input ``x`` (B, S,
    d) and ``params`` (the q and k weights, biases and norm scales):
    ``norm_engages``' rule, a head width the kernel takes, int64 positions
    on x's device."""
    return (_on_card(x) and _plain_bf16(x, positions, *params) and x.dim() == 3
            and positions.dtype == torch.int64 and positions.dim() <= 2
            and head_dim % 16 == 0 and 0 < head_dim <= _norm.ROPE_MAX_D)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             residual: Optional[torch.Tensor] = None):
    """RMSNorm of x's rows, (1 + scale), in x's dtype; with ``residual``
    (normed ``residual + x``, the sum).  One launch on the card (bf16 rows
    whose width is a multiple of 8), the plain chain on the CPU."""
    return _norm.rms_norm(x, scale, eps, residual)


def qk_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float, *,
            q_norm: Optional[torch.Tensor] = None, k_norm: Optional[torch.Tensor] = None,
            bq: Optional[torch.Tensor] = None, bk: Optional[torch.Tensor] = None,
            eps: float = 1e-6):
    """q (B, S, H, D), k (B, S, KV, D) -> (q, k) biased, normed per head and
    rotated, one launch for both on the card, in place into q and k (see
    ``norm_rope.qk_rope``); the plain chain on the CPU."""
    return _norm.qk_rope(q, k, positions, theta, q_norm=q_norm, k_norm=k_norm, bq=bq, bk=bk,
                         eps=eps)
