"""Mixture-of-Experts layer with sort-based (one-hot-free) token dispatch.

Port of ``repro/models/moe.py`` (llama4-maverick: 128 routed experts, top-1,
plus a shared expert; qwen2-moe: 60 routed experts, top-4 renormalised, 4
shared experts).  Tokens are stably sorted by expert id, each gets its
position within its expert's group, and those past the capacity ``C = max(8,
k * N * capacity_factor / E)`` are dropped (their residual passes through).
``N`` is every token of the call, so the capacity and which tokens are
dropped couple the rows of a batch: a prefill of several prompts is not the
prefills of each alone.

As in the reference, routing runs in fp32 with an fp32 router weight (the
port keeps the router in fp32 whatever ``cfg.dtype`` is, and runs the
product at full fp32: TF32 would flip top-k picks); ``top_k`` gives the lower
expert id on ties, as ``jax.lax.top_k`` does.  The expert products are
batched matmuls over (E, C, *) buffers.  The k outputs of a token are summed
in a fixed order (gathered back by the inverse permutation), so the card's
result does not depend on the order of atomics.  The Switch load-balancing
auxiliary loss is returned.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import fp32_matmul
from .layers import dense_init, frozen, mlp_apply, mlp_init, param_dict
from .partitioning import at_use, like, relayout, shard, whole


def expert_init(gen: torch.Generator, n: int, in_dim: int, out_dim: int, *, device,
                dtype: torch.dtype) -> torch.Tensor:
    """(n, in, out) normal / sqrt(in), drawn one expert at a time in fp32 and
    stored in ``dtype`` (a full-width fp32 draw of llama4's experts alone
    would take 43 GB)."""
    w = torch.empty((n, in_dim, out_dim), device=device, dtype=dtype)
    for e in range(n):
        w[e] = torch.randn((in_dim, out_dim), generator=gen, device=device,
                           dtype=torch.float32).div_(math.sqrt(in_dim))
    return w


class MoEParams(nn.Module):
    """``router`` (d, E) fp32, ``wi`` (E, d, 2ff), ``wo`` (E, ff, d) and,
    with shared experts, ``shared`` (an MLP of width ff * n_shared): the
    reference's ``moe`` subtree."""

    def __init__(self, gen: torch.Generator, cfg, *, device, dtype: torch.dtype):
        super().__init__()
        e, d = cfg.n_experts, cfg.d_model
        ff = cfg.moe_d_ff or cfg.d_ff
        self.router = frozen(dense_init(gen, d, e, scale=0.02, device=device))
        self.wi = frozen(expert_init(gen, e, d, 2 * ff, device=device, dtype=dtype))
        self.wo = frozen(expert_init(gen, e, ff, d, device=device, dtype=dtype))
        self.shared: Optional[nn.ParameterDict] = None
        if cfg.n_shared_experts:
            self.shared = param_dict(mlp_init(gen, d, ff * cfg.n_shared_experts,
                                              device=device, dtype=dtype))


def capacity(n_tokens: int, cfg) -> int:
    c = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, c)


def route(params: MoEParams, xf: torch.Tensor, cfg):
    """xf (N, d) -> (probs (N, E), gates (N, k), expert ids (N, k) int64):
    the fp32 softmax router and its top k, lower id first on ties (a stable
    descending sort), gates renormalised when ``cfg.renorm_topk`` and k > 1."""
    with fp32_matmul():
        logits = xf.float() @ params.router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_ids = vals[:, :cfg.top_k], ids[:, :cfg.top_k]
    if getattr(cfg, "renorm_topk", True) and cfg.top_k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return probs, gates, expert_ids


def expert_counts(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many of ``ids`` pick each expert, (E,) int64: ``bincount`` with
    ``minlength=E``, whose output length would depend on the ids' values."""
    return ids.new_zeros(n_experts, dtype=torch.long).index_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.long))


def dispatch(expert_ids: torch.Tensor, n_experts: int, cap: int):
    """The sort-based dispatch of (N, k) expert ids -> (sort_idx, slot, keep),
    each over the N*k (token, pick) pairs in expert order: a pair's slot in
    the (E * C) buffer, E * C where it is dropped (past its expert's
    capacity)."""
    flat = expert_ids.reshape(-1)
    sort_idx = torch.argsort(flat, stable=True)
    sorted_expert = flat[sort_idx]
    counts = expert_counts(flat, n_experts)
    group_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat.numel(), device=flat.device) - group_start[sorted_expert]
    keep = pos < cap
    slot = torch.where(keep, sorted_expert * cap + pos, n_experts * cap)
    return sort_idx, slot, keep


def moe_apply(params: MoEParams, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux loss).  With ``cfg.moe_dispatch_groups = G`` > 1
    (and B*S a multiple of G) the tokens are routed in G independent groups,
    each with its own capacity, and aux is their mean."""
    groups = getattr(cfg, "moe_dispatch_groups", 0) or 0
    B, S, d = x.shape
    if groups > 1 and (B * S) % groups == 0:
        xg = shard(x.reshape(groups, (B * S) // groups, 1, d), "batch", None, None, "embed")
        outs = [_moe_dispatch(params, xs, cfg) for xs in xg]
        y = shard(torch.stack([o[0] for o in outs]), "batch", None, None, "embed").reshape(B, S, d)
        return y, torch.stack([o[1] for o in outs]).mean()
    return _moe_dispatch(params, x, cfg)


def _moe_dispatch(params: MoEParams, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    C = capacity(N, cfg)
    xs = x.reshape(N, d)
    # Under a mesh every rank routes all N tokens (whole, replicated): the
    # capacity couples them, and the sort and count ops have no DTensor
    # rules.  The expert products run on the (E, C, d) buffer sharded as
    # "experts" says.
    xf = whole(xs)
    probs, gates, expert_ids = route(SimpleNamespace(router=whole(params.router)), xf, cfg)
    # Switch-style load-balance aux loss: E * sum(mean prob * dispatch fraction)
    density = expert_counts(expert_ids[:, 0], E).float() / N
    aux = like(E * torch.sum(probs.mean(dim=0) * density), x)

    sort_idx, slot, keep = dispatch(expert_ids, E, C)
    token_idx = sort_idx // k
    # every pair is written, the dropped ones to a spare row past the buffer
    # (no data-dependent shape: a dry run's fake tensors have no values)
    buf = xf.new_zeros((E * C + 1, d))
    buf[slot] = xf[token_idx]
    buf = shard(like(buf[:E * C].reshape(E, C, d), x), "experts", "expert_cap", "embed")

    # expert computation: fused gate+up, (E, C, *) batched products
    # the fused gate+up product whole over its output dim before the split
    # (its halves lie on different ranks of the axis that shards it)
    gate, up = relayout(torch.bmm(buf, at_use(params.wi, x.dtype, keep_dim=0)),
                        "experts", "expert_cap", None).chunk(2, dim=-1)
    eout = shard(torch.bmm(F.silu(gate) * up, at_use(params.wo, x.dtype, keep_dim=0)),
                 "experts", "expert_cap", "embed")

    # combine: each (token, pick) pair's gated output back in token order,
    # then the k picks of a token summed in pick order
    flat_out = torch.cat([whole(eout).reshape(E * C, d), xf.new_zeros((1, d))])
    g = torch.where(keep, gates.reshape(-1)[sort_idx].to(x.dtype), 0.0)
    y_k = flat_out[slot] * g[:, None]
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(N * k, device=xf.device)
    y = like(y_k[inv].reshape(N, k, d).sum(dim=1), x)

    if params.shared is not None:
        y = y + mlp_apply(params.shared, xs, act="silu")
    return y.reshape(B, S, d), aux
