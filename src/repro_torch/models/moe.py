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

Under a mesh with ``moe_dispatch_groups`` > 1, each data rank routes its own
groups and the tokens reach their experts by all-to-all, the reference's
expert parallelism (``_expert_parallel``); experts that the mesh axis does
not divide are split unevenly, as the reference's constraint splits them.
Without groups every rank routes every token (the capacity couples them),
and each rank computes its experts over its chunk of their hidden where
"fsdp" places the weights (``_split_hidden``), and a decode step's shared
MLP over its chunk of d (``_shared_mlp``): the products the reference's
compiled dry run splits.
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
from .partitioning import (UNCONSTRAINED, _Constrain, _local, _narrow_cat, at_use,
                           contiguous_strides, fit, get_mesh, is_dtensor, like,
                           local_shape_and_offset, placements, relayout, replicated_placements,
                           shard, shard_uneven, spec, whole)


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


def _route_group(router: torch.Tensor, xf: torch.Tensor, cfg, cap: int):
    """Route the (N, d) tokens ``xf`` and write them into an (E, C, d)
    buffer -> (aux loss, buffer, (gates, sort_idx, slot, keep) for
    ``_combine``)."""
    E, d = cfg.n_experts, xf.shape[1]
    # the router's and the buffer's gradients meet at a node of their own
    # before the shared MLP's joins them, whatever the caller's layout: plain
    # tensors and DTensors of one rank then sum them in one order (bf16
    # addition does not associate)
    xf = xf.view_as(xf)
    probs, gates, expert_ids = route(SimpleNamespace(router=router), xf, cfg)
    # Switch-style load-balance aux loss: E * sum(mean prob * dispatch fraction)
    density = expert_counts(expert_ids[:, 0], E).float() / xf.shape[0]
    aux = E * torch.sum(probs.mean(dim=0) * density)
    sort_idx, slot, keep = dispatch(expert_ids, E, cap)
    # every pair is written, the dropped ones to a spare row past the buffer
    # (no data-dependent shape: a dry run's fake tensors have no values)
    buf = xf.new_zeros((E * cap + 1, d))
    buf[slot] = xf[sort_idx // cfg.top_k]
    return aux, buf[:E * cap].reshape(E, cap, d), (gates, sort_idx, slot, keep)


def _combine(eout: torch.Tensor, picks, dtype: torch.dtype) -> torch.Tensor:
    """Each (token, pick) pair's gated output, from the whole (E, C, d)
    expert output, back in token order, then the k picks of a token summed
    in pick order -> (N, d)."""
    gates, sort_idx, slot, keep = picks
    (N, k), (E, C, d) = gates.shape, eout.shape
    flat_out = torch.cat([eout.reshape(E * C, d), eout.new_zeros((1, d))])
    g = torch.where(keep, gates.reshape(-1)[sort_idx].to(dtype), 0.0)
    y_k = flat_out[slot] * g[:, None]
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(N * k, device=slot.device)
    return y_k[inv].reshape(N, k, d).sum(dim=1)


def moe_apply(params: MoEParams, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux loss).  With ``cfg.moe_dispatch_groups = G`` > 1
    (and B*S a multiple of G) the tokens are routed in G independent groups,
    each with its own capacity, and aux is their mean.  Under a mesh, when
    each group lies whole inside one rank's batch shard, each rank routes
    its own groups and the tokens reach their experts by all-to-all
    (``_expert_parallel``); a group that straddles two ranks' shards is
    routed whole on every rank, as without groups."""
    groups = getattr(cfg, "moe_dispatch_groups", 0) or 0
    B, S, d = x.shape
    if groups > 1 and (B * S) % groups == 0:
        xp = _group_placements(x, groups)
        if xp is not None:
            return _expert_parallel(params, x, cfg, groups, xp)
        # a group across two ranks' shards: the batch gathered before the
        # groups are cut (DTensor cannot cut a dim unevenly)
        xg = shard(shard(x, None, "seq", "embed").reshape(groups, (B * S) // groups, 1, d),
                   "batch", None, None, "embed")
        outs = [_moe_dispatch(params, xs, cfg) for xs in xg]
        y = shard(torch.stack([o[0] for o in outs]), "batch", None, None, "embed").reshape(B, S, d)
        if is_dtensor(y):   # y's gradient gathered before it is cut into the groups
            y = shard(_Constrain.apply(y, replicated_placements(y.device_mesh)),
                      "batch", "seq", "embed")
        return y, torch.stack([o[1] for o in outs]).mean()
    return _moe_dispatch(params, x, cfg)


def _group_placements(x: torch.Tensor, groups: int):
    """Under a mesh, x's placements with its batch over the batch axes, if
    each of the ``groups`` lies whole in one rank's batch shard; else None."""
    mesh = get_mesh()
    if mesh is None or not is_dtensor(x):
        return None
    xp = placements(fit(spec("batch", None, None), x.shape, mesh), mesh)
    n = math.prod(mesh.size(i) for i, p in enumerate(xp) if p.is_shard())
    return xp if groups % n == 0 else None


class _GroupGrad(torch.autograd.Function):
    """Identity on a weight that each rank applies to its own groups on the
    mesh dims ``dims``, where the group's buffer is labelled replicated: its
    gradient there is the rank's partial sum, and is labelled so."""

    @staticmethod
    def forward(ctx, w, dims):
        ctx.dims = dims
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial

        assert all(grad.placements[i].is_replicate() for i in ctx.dims), grad.placements
        want = tuple(Partial() if i in ctx.dims else p for i, p in enumerate(grad.placements))
        return DTensor.from_local(grad.to_local(), grad.device_mesh, want, shape=grad.shape,
                                  stride=grad.stride()), None


def _on_experts(w: torch.Tensor, q, kept) -> torch.Tensor:
    """Expert weight ``w`` (E, in, out) gathered over its FSDP axes and split
    over the experts as a group's (E, C, d) buffer is (``q``), unevenly where
    the axes do not divide E; its other dims as they are (the hidden over
    "model").  ``kept``: the mesh dims on which each rank holds its own
    groups (``_GroupGrad``)."""
    w = at_use(w, w.dtype, keep_dim=0)
    if q is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Shard(0) if qp.is_shard() else Replicate() if p.is_shard() and p.dim == 0
                 else p for p, qp in zip(w.placements, q))
    if want != tuple(w.placements):
        w = w.redistribute(w.device_mesh, want)
    return _GroupGrad.apply(w, kept) if kept else w


def _experts(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The expert computation on an (E, C, d) buffer: the fused gate+up and
    the down product, batched over the experts (on a DTensor, each rank's
    experts: the weights placed by ``_on_experts``).  The fused product is
    made whole over its output dim before the split (its halves lie on
    different ranks of the axis that shards it); the output is reduced to
    the buffer's placements."""
    gate_up = torch.bmm(buf, wi.to(dtype))
    if is_dtensor(buf):
        gate_up = gate_up.redistribute(buf.device_mesh, tuple(buf.placements))
    gate, up = gate_up.chunk(2, dim=-1)
    h = F.silu(gate) * up
    if is_dtensor(h):
        from torch.distributed.tensor import Shard

        # the hidden back on wo's shards of it before the product, and so
        # its saved copy: wo's gradient is then each rank's shard alone
        want = tuple(Shard(2) if w.is_shard() and w.dim == 1 else p
                     for p, w in zip(buf.placements, wo.placements))
        h = h if tuple(h.placements) == want else _Constrain.apply(h, want)
    return shard_uneven(torch.bmm(h, wo.to(dtype)), "experts", "expert_cap", "embed")


def _expert_parallel(params: MoEParams, x: torch.Tensor, cfg, G: int, xp
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped MoE of a DTensor ``x`` whose batch shard on each rank
    (placements ``xp``) holds whole groups, group for group the arithmetic
    of ``_moe_dispatch``: each rank routes its own groups on local tensors
    (the router gathered, its gradient a partial sum over the batch axes)
    and stacks their buffers into a (G, E, C, d) DTensor with the groups
    over the batch axes, which ``shard_uneven`` moves to the experts' axes
    as the reference's constraint inside its vmap does (experts over "data":
    an all-to-all; over "model": a local slice), 60 experts over 16 ranks 4
    a rank.  Each rank runs every group it then holds through its experts'
    slices of ``wi`` and ``wo``; the outputs move back by the inverse
    all-to-all and each group is combined, and takes its shared experts, on
    its own rank.  y keeps x's batch placements; aux is the mean over all G
    groups."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    B, S, d = x.shape
    E = cfg.n_experts
    n = B * S // G
    C = capacity(n, cfg)
    batch = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    router = _local(params.router, mesh, replicated_placements(mesh), batch)
    xs = shard(x, "batch", "seq", "embed").to_local(grad_placements=xp).reshape(-1, n, d).unbind(0)
    auxes, bufs, picks = zip(*(_route_group(router, xf, cfg, C) for xf in xs))

    # the groups' buffers to the experts' axes; each group's (E, C, d) there
    # placed ``q`` (the mesh dims that keep whole groups on each rank
    # replicated: a rank's own groups, which only the weights' gradient sees)
    shape, eshape = (G, E, C, d), (E, C, d)
    buf = DTensor.from_local(torch.stack(bufs), mesh, xp, shape=shape,
                             stride=contiguous_strides(shape))
    buf = shard_uneven(buf, UNCONSTRAINED, "experts", "expert_cap", "embed")
    pt = tuple(buf.placements)
    q = tuple(Shard(p.dim - 1) if p.is_shard() and p.dim else Replicate() for p in pt)
    kept = tuple(i for i, p in enumerate(pt) if p.is_shard() and p.dim == 0)
    wi, wo = (_on_experts(w, q, kept) for w in (params.wi, params.wo))
    outs = []
    for b in buf.to_local(grad_placements=pt).unbind(0):
        b = DTensor.from_local(b, mesh, q, shape=eshape, stride=contiguous_strides(eshape))
        outs.append(_experts(b, wi, wo, x.dtype).to_local(grad_placements=q))
    eout = DTensor.from_local(torch.stack(outs), mesh, pt, shape=shape,
                              stride=contiguous_strides(shape))
    eout = shard_uneven(eout, "batch", None, None, "embed").to_local(grad_placements=xp)

    # combine each group on its rank, as _moe_dispatch does
    ys = []
    for xf, eo, pick in zip(xs, eout.unbind(0), picks):
        y = _combine(eo, pick, x.dtype)
        if params.shared is not None:
            # the rank's group beside the other ranks' as one DTensor
            shared = mlp_apply(params.shared, DTensor.from_local(xf, mesh, xp), act="silu")
            y = y + shared.to_local(grad_placements=xp)
        ys.append(y)
    y = DTensor.from_local(torch.stack(ys).reshape(-1, S, d), mesh, xp, shape=x.shape,
                           stride=contiguous_strides(x.shape))
    aux = DTensor.from_local(torch.stack(auxes).mean(), mesh, batch)
    # the mean of the ranks' means: each rank holds G / len(xs) groups
    return y, aux.redistribute(mesh, replicated_placements(mesh)) / (G // len(xs))


def _hidden_placements(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor):
    """The mesh dims that split the experts' hidden, where the weights are
    placed as "fsdp" places them: ``wi`` (at use) on ``buf``'s placements
    (experts over the experts' axes, whole elsewhere) and ``wo``'s hidden
    rows (dim 1) sharded on mesh dims where ``buf`` is whole, its experts
    as ``buf``'s or whole (60 experts, which 16 ranks do not divide, are
    stored whole).  -> those dims (maybe none), or None where the weights
    are placed otherwise ("ep": wi's columns over "model")."""
    if tuple(wi.placements) != tuple(buf.placements):
        return None
    hidden = []
    for j, (p, b) in enumerate(zip(wo.placements, buf.placements)):
        if p.is_shard(1) and b.is_replicate():
            hidden.append(j)
        elif p != b and not (p.is_replicate() and b.is_shard(0)):
            return None
    return tuple(hidden)


def _split_hidden(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, hidden,
                  dtype: torch.dtype) -> torch.Tensor:
    """The expert products of a DTensor buffer (E, C, d) on local tensors,
    each rank's experts (``buf``'s chunk) over its chunk of the hidden, the
    reference's compiled layout under "fsdp": wo's rows stay where they are
    stored (its hidden over the ``hidden`` mesh dims, the batch axes; a
    rank's experts sliced where they are stored whole), wi's gate and up
    columns for those rows are sliced from the gathered weight, and each
    rank's output is a partial sum over ``hidden``, reduced and scattered
    there over the capacity.  -> (E, C, d), a DTensor with the experts as
    ``buf``'s and the capacity over ``hidden``; the gradients come back as
    partial sums (buf's and wi's over ``hidden``, wo's over the dims where
    its experts were sliced)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh, bp = buf.device_mesh, tuple(buf.placements)
    part = tuple(Partial() if j in hidden else p for j, p in enumerate(bp))
    (er, _, _), (e0, _, _) = local_shape_and_offset(buf.shape, mesh, bp)
    shape, offset = local_shape_and_offset(wo.shape, mesh, wo.placements)
    ff, f0, fr = wo.shape[1], offset[1], shape[1]
    w_in = _narrow_cat(wi.to_local(grad_placements=part), 2,
                       [(f0, f0 + fr), (ff + f0, ff + f0 + fr)])
    gate_up = torch.bmm(buf.to_local(grad_placements=part), w_in)
    gate, up = gate_up.chunk(2, dim=-1)
    h = F.silu(gate) * up
    sliced = tuple(Partial() if p.is_replicate() and b.is_shard() else p
                   for p, b in zip(wo.placements, bp))
    w_out = wo.to(dtype).to_local(grad_placements=sliced)
    if shape[0] != er:
        w_out = w_out.narrow(0, e0, er)
    out = DTensor.from_local(torch.bmm(h, w_out), mesh, part, shape=buf.shape,
                             stride=contiguous_strides(buf.shape))
    # the partial sums reduced and scattered over the capacity (the caller
    # gathers the whole output: no second whole-size buffer meanwhile)
    return out.redistribute(mesh, tuple(Shard(1) if j in hidden else p
                                        for j, p in enumerate(bp)))


def _dispatch_experts(params: MoEParams, buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The expert products of ``_moe_dispatch``'s (E, C, d) buffer: over each
    rank's chunk of the experts' hidden where the weights are placed as
    "fsdp" places them (``_split_hidden``), else through ``_experts`` with
    the weights split as the buffer's experts are."""
    q = tuple(buf.placements) if is_dtensor(buf) else None
    wi = _on_experts(params.wi, q, ())
    hidden = None if q is None else _hidden_placements(buf, wi, params.wo)
    if hidden is None:
        return _experts(buf, wi, _on_experts(params.wo, q, ()), dtype)
    return _split_hidden(buf, wi, params.wo, hidden, dtype)


def _shared_mlp(shared, xs: torch.Tensor) -> torch.Tensor:
    """The shared experts' MLP on the (N, d) tokens ``xs``.  Under a mesh, a
    rank with fewer tokens than d_model (a decode step) splits the gate and
    up product's contraction over "ff" (d over "model", where the tokens
    are whole), and the partial products are summed there, as the
    reference's compiled decode splits it; with more (a prefill, a train
    step) each rank computes its tokens over the whole hidden, as the
    reference does."""
    mesh = get_mesh()
    if mesh is not None and is_dtensor(xs) and \
            local_shape_and_offset(xs.shape, mesh, xs.placements)[0][0] < xs.shape[-1]:
        shared = {"wi": relayout(at_use(shared["wi"], xs.dtype), "ff", None),
                  "wo": shared["wo"]}
        xs = relayout(xs, "batch", "ff")
    return mlp_apply(shared, xs, act="silu")


def _moe_dispatch(params: MoEParams, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    N = B * S
    C = capacity(N, cfg)
    xs = x.reshape(N, d)
    # Under a mesh every rank routes all N tokens (whole, replicated): the
    # capacity couples them, and the sort and count ops have no DTensor
    # rules.  The expert products run on the (E, C, d) buffer sharded as
    # "experts" says, unevenly where the axes do not divide E, and over the
    # experts' hidden where "fsdp" shards it (``_split_hidden``).
    xf = whole(xs)
    aux, buf, picks = _route_group(whole(params.router), xf, cfg, C)
    buf = shard_uneven(like(buf, x), "experts", "expert_cap", "embed")
    eout = _dispatch_experts(params, buf, x.dtype)
    y = like(_combine(whole(eout), picks, x.dtype), x)

    if params.shared is not None:
        y = y + _shared_mlp(params.shared, xs)
    return y.reshape(B, S, d), like(aux, x)
