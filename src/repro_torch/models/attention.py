"""Attention: GQA/MQA/MHA with RoPE, soft-capping, sliding windows, qk-norm.

Port of ``repro/models/attention.py``.  Every attention call goes through
the kernel layer: self- and cross-attention through ``ops.flash_attention``
(K6), self-attention with ``cfg.attn_impl == "blocked"`` through
``blocked_attention`` (the reference's flash-style route, which is K6's
contract: it calls the same kernel), and one decode step through
``ops.decode_attention`` (K7).  q and k take the reference's logical
sharding (``partitioning.split_heads`` and ``shard``; no-ops without a
mesh).  On the CUDA card these launch the hand-written kernels; on the
CPU they run the kernels' plain versions, so the CPU tests drive the same
arguments (scale, softcap, window, kv_len) that the card receives.  ``attn_core`` keeps the
reference's plain math as a test reference.

Numerics: the kernels take fp32 logits from the inputs' values; the
reference's plain path rounds its logits einsum to the activation dtype
first (bf16 in serving).  At fp32 the two agree within the tests' 2e-5.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import apply_rope
from .blocked_attention import blocked_attention
from .layers import dense_init, rms_norm, softcap, zeros_init
from .partitioning import at_use, merge_heads, shard, split_heads, write_slots


class AttnDims(NamedTuple):
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int


def attn_dims(cfg) -> AttnDims:
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    return AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd)


# ----------------------------------------------------------------------- init
def attention_init(gen: torch.Generator, cfg, *, device=None,
                   dtype: torch.dtype = torch.float32) -> dict:
    d = attn_dims(cfg)
    kw = {"device": device, "dtype": dtype}
    params = {
        "wq": dense_init(gen, d.d_model, d.n_heads * d.head_dim, **kw),
        "wk": dense_init(gen, d.d_model, d.n_kv * d.head_dim, **kw),
        "wv": dense_init(gen, d.d_model, d.n_kv * d.head_dim, **kw),
        "wo": dense_init(gen, d.n_heads * d.head_dim, d.d_model, **kw),
    }
    if getattr(cfg, "qkv_bias", False):
        params["bq"] = torch.zeros((d.n_heads * d.head_dim,), **kw)
        params["bk"] = torch.zeros((d.n_kv * d.head_dim,), **kw)
        params["bv"] = torch.zeros((d.n_kv * d.head_dim,), **kw)
    if getattr(cfg, "qk_norm", False):
        params["q_norm"] = zeros_init(d.head_dim, device=device)
        params["k_norm"] = zeros_init(d.head_dim, device=device)
    return params


# ----------------------------------------------------------------- projection
def project_q(params, x: torch.Tensor, cfg, positions: torch.Tensor,
              uneven: bool = False) -> torch.Tensor:
    """q (..., S, n_heads, head_dim), normed and rotated; with ``uneven``
    its heads split over the model axis where it does not divide them
    (``split_heads``)."""
    d = attn_dims(cfg)
    q = x @ at_use(params["wq"], x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = split_heads(q, d.n_heads, "heads", "batch", "seq", uneven=uneven)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], getattr(cfg, "norm_eps", 1e-6))
    return apply_rope(q, positions, cfg.rope_theta)


def project_kv(params, x: torch.Tensor, cfg,
               positions: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    d = attn_dims(cfg)
    k = x @ at_use(params["wk"], x.dtype)
    v = x @ at_use(params["wv"], x.dtype)
    if "bk" in params:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    k = split_heads(k, d.n_kv, "kv", "batch", "seq")
    v = split_heads(v, d.n_kv, "kv", "batch", "seq")
    if "k_norm" in params:
        k = rms_norm(k, params["k_norm"], getattr(cfg, "norm_eps", 1e-6))
    if positions is not None:  # cross-attention keys carry no rope
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def project_qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor,
                uneven: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention's q, k and v, as ``project_q`` and ``project_kv``
    give them.  Where ``ops.rope_engages`` (a served bf16 model on the
    card), q's and k's bias, per-head norm and rotation are one launch
    (``ops.qk_rope``) on the projections' outputs, in place; v's bias stays
    a bf16 add."""
    d = attn_dims(cfg)
    extra = {n: params[n] for n in ("bq", "bk", "q_norm", "k_norm") if n in params}
    if not ops.rope_engages(x, positions, d.head_dim, params["wq"], params["wk"],
                            *extra.values()):
        return (project_q(params, x, cfg, positions, uneven=uneven),
                *project_kv(params, x, cfg, positions))
    B, S, _ = x.shape
    q = (x @ at_use(params["wq"], x.dtype)).view(B, S, d.n_heads, d.head_dim)
    k = (x @ at_use(params["wk"], x.dtype)).view(B, S, d.n_kv, d.head_dim)
    v = x @ at_use(params["wv"], x.dtype)
    if "bv" in params:
        v = v + params["bv"].to(x.dtype)
    bias = {n: extra[n].to(x.dtype) for n in ("bq", "bk") if n in extra}
    q, k = ops.qk_rope(q, k, positions, cfg.rope_theta, q_norm=extra.get("q_norm"),
                       k_norm=extra.get("k_norm"), **bias, eps=getattr(cfg, "norm_eps", 1e-6))
    return q, k, v.view(B, S, d.n_kv, d.head_dim)


def _scale(cfg, head_dim: int) -> float:
    qs = getattr(cfg, "query_pre_attn_scalar", None)
    return 1.0 / math.sqrt(qs if qs is not None else head_dim)


# ----------------------------------------------------------------- core math
def attn_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, cfg,
              causal: bool = True, window: Optional[int] = None,
              q_positions: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's plain grouped-query attention, kept to test the
    kernel route against: logits einsum in the inputs' dtype, then f32
    softmax, -1e30 masking."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = softcap(logits * _scale(cfg, D), getattr(cfg, "attn_logit_softcap", None))

    qpos = q_positions if q_positions is not None else torch.arange(S, device=q.device)[None, :]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((B if qpos.shape[0] > 1 else 1, S, T), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kpos[:, None, :] <= qpos[..., :, None]
    if window is not None:
        mask &= kpos[:, None, :] > (qpos[..., :, None] - window)
    if kv_len is not None:
        mask &= kpos[:, None, :] < kv_len.reshape(-1, 1, 1)
    logits = logits.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D)


# ----------------------------------------------------------------- full apply
def attention_apply(params, x: torch.Tensor, cfg, *,
                    positions: Optional[torch.Tensor] = None, causal: bool = True,
                    window: Optional[int] = None, memory: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Self-attention over x (B, S, d_model), or cross-attention over
    ``memory`` (B, T, d_model) without a causal mask.  ``positions`` (default
    0..S-1) rotate q and k; the causal and window masks compare sequence
    indices, as the kernel does, so they equal positions only for 0..S-1.
    Under a mesh each rank of "model" holds and computes only its own q
    heads, split unevenly where the axis does not divide them, as the
    reference's constraint splits them: q's columns move from wq's shards
    to the rank's heads, K6 runs on those heads
    (``ops.sharded_flash_attention``), and the output moves back to wo's
    rows (``split_heads``, ``merge_heads``)."""
    B, S, _ = x.shape
    pos = positions if positions is not None else torch.arange(S, device=x.device)[None, :]
    if memory is None:
        q, k, v = project_qkv(params, x, cfg, pos, uneven=True)
    else:
        q = project_q(params, x, cfg, pos, uneven=True)
        k, v = project_kv(params, memory, cfg, None)
        causal = False
    # q is placed by split_heads (the reference's "heads" constraint)
    k = shard(k, "batch", "seq", "kv", "head_dim")
    kw = {"causal": causal, "window": window,
          "softcap": getattr(cfg, "attn_logit_softcap", None), "scale": _scale(cfg, q.shape[-1])}
    if getattr(cfg, "attn_impl", "naive") == "blocked" and memory is None:
        out = blocked_attention(q, k, v, block_q=getattr(cfg, "attn_block_q", 2048),
                                block_k=getattr(cfg, "attn_block_k", 1024), **kw)
    else:
        out = ops.flash_attention(q, k, v, **kw)
    # the residual stream's layout: a row-parallel product's partial sums
    # are reduced here, as the reference constrains the block's output
    y = shard(merge_heads(out) @ at_use(params["wo"], x.dtype), "batch", "seq", "embed")
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(params, x: torch.Tensor, cfg, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int):
    """One decode step against a (ring-buffer) KV cache (B, W, KV, D).

    The new k/v are written in place at slot ``pos % W`` (the reference
    returns an updated copy); masking needs only the valid slot count
    ``min(pos + 1, W)``, since keys carry their true RoPE positions and the
    softmax does not care about slot order.  A DTensor cache sharded over
    its slots (``cache_spec``'s context parallelism) takes the new k/v on
    the rank whose shard holds the slot, in that shard
    (``partitioning.write_slots``), and K7 runs on every rank's shard
    (``ops.sharded_decode_attention``).  Under ``embed_split`` (a batch of 1
    on a mesh) x is split over "data" on d: the q, k and v products give
    partial sums that ``split_heads`` reduces, K7 takes the rank's share of
    the heads, and ``wo`` gives each rank its chunk of d, reduced over
    "model" into x's layout.  Returns (y, k_cache, v_cache).
    """
    B = x.shape[0]
    W = k_cache.shape[1]
    pos_b = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    # q stays on split_heads' even path: K7's route gathers q whole over
    # "model" (the reference constrains no q here), so an uneven split would
    # only add an all-to-all a layer and token (gemma-2b's and qwen2.5-14b's
    # decode_32k dry runs on 16 x 16: the same FLOPs, and 18 and 48 more
    # all-to-alls a step, one in each layer)
    q, k_new, v_new = project_qkv(params, x, cfg, pos_b)
    write_slots(k_cache, k_new, pos % W)
    write_slots(v_cache, v_new, pos % W)
    kv_len = torch.full((B,), min(pos + 1, W), dtype=torch.int32, device=x.device)
    out = ops.decode_attention(q[:, 0], k_cache, v_cache, kv_len,
                               softcap=getattr(cfg, "attn_logit_softcap", None),
                               scale=_scale(cfg, q.shape[-1]))
    y = shard(merge_heads(out[:, None]) @ at_use(params["wo"], x.dtype), "batch", "seq", "embed")
    return y, k_cache, v_cache
