"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Layers are plain functions over
tensors; parameters live in ``nn.ParameterDict``s (see ``transformer.py``)
with the reference's names and (in, out) matrix layout, so ``x @ w`` reads
the same in both packages and a JAX parameter tree converts leaf by leaf.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .partitioning import (
    EmbedSplit,
    at_use,
    contiguous_strides,
    get_mesh,
    is_dtensor,
    local_shape_and_offset,
    placements,
    relayout,
    replicated_placements,
    shard,
    spec,
    split_axes,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------- dtype
def activation_dtype(cfg) -> torch.dtype:
    return _DTYPES[getattr(cfg, "dtype", "bfloat16")]


# ----------------------------------------------------------------------- init
# The reference draws every leaf in fp32 (normal * scale) from a JAX key; the
# port draws the same distributions from an explicit torch.Generator.  The
# two give different numbers from one seed: tests convert the reference's
# draw (``convert.model_from_jax``) instead.
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               scale: Optional[float] = None, *, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, *, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=device, dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


def zeros_init(dim: int, *, device=None) -> torch.Tensor:
    """Norm scales: zero (the (1 + scale) parameterisation), kept in fp32."""
    return torch.zeros((dim,), device=device, dtype=torch.float32)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient (the port serves)."""
    return nn.Parameter(t, requires_grad=False)


def trainable_masters(module: nn.Module) -> nn.Module:
    """Make every parameter of ``module`` (built with fp32 weights) a
    trainable master that takes a gradient.  The layers cast each at use
    to the activation dtype (``w.to(x.dtype)``), as the reference casts its
    fp32 masters, so the forward's numbers do not change."""
    for name, p in module.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(f"{name}: a trainable master must be float32, not {p.dtype}")
        p.requires_grad_(True)
    return module


def param_dict(tensors: dict) -> nn.ParameterDict:
    """A reference parameter subtree (a flat dict of tensors) as frozen
    parameters under the same names."""
    return nn.ParameterDict({k: frozen(v) for k, v in tensors.items()})


# ---------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, returned in x's dtype, with gemma's zero-centred
    (1 + scale) parameterisation."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(dt)


# ----------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).  Split halves
    (not interleaved), angles in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    angles = positions[..., None].float() * freqs               # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ soft caps
def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------------------------------------------------ mlp
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *, device=None,
             dtype: torch.dtype = torch.float32) -> dict:
    return {
        "wi": dense_init(gen, d_model, 2 * d_ff, device=device, dtype=dtype),  # gate|up
        "wo": dense_init(gen, d_ff, d_model, device=device, dtype=dtype),
    }


def mlp_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: SwiGLU (act='silu') or GeGLU (act='gelu', gemma).

    On a mesh (x a DTensor, rows over the batch axes) wi's output dim is
    sharded over "model", and its two halves, gate and up, lie on different
    ranks: the product is gathered over "model" before the split, the
    gated hidden goes back to its "ff" shards, and the row-parallel wo's
    partial sums are reduced to the residual stream's layout.  Each of
    these is a no-op for a plain tensor.  Under ``embed_split`` x's d is
    split over "data" as wi's rows and wo's columns are stored: wi's
    partial sums are reduced with the gather over "model", and wo gives
    each rank its chunk of d."""
    lead = ("batch",) + ("seq",) * (x.ndim - 2)
    gate, up = relayout(x @ at_use(params["wi"], x.dtype), *lead, None).chunk(2, dim=-1)
    if act == "silu":
        g = F.silu(gate)
    elif act == "gelu":
        g = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    h = shard(g * up, *lead, "ff")
    return shard(h @ at_use(params["wo"], x.dtype), *lead, "embed")


# ------------------------------------------------------------------ embedding
def embed_apply(table: torch.Tensor, tokens: torch.Tensor, scale: bool,
                d_model: int) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` (a DTensor table sharded over its
    vocabulary, or any DTensor table under ``embed_split``: ``vocab_rows``)."""
    if is_dtensor(table) and (any(p.is_shard(0) for p in table.placements) or split_axes()):
        x = vocab_rows(table, tokens)
    else:
        x = table[tokens.to(table.device, torch.long)]
    if scale:  # gemma scales embeddings by sqrt(d_model)
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype, device=x.device)
    return x


def vocab_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a DTensor table whose rows (the vocabulary) are
    sharded over some mesh axes, without gathering the table: each rank
    takes the rows it holds (zeros for the others) for its tokens, whole
    over the vocabulary's axes and split as the tokens are over the others,
    and the partial rows are summed over the vocabulary's axes (an
    all-reduce).  The table's gradient stays on its shards: partial over
    the axes that split the tokens, as a gathered batch's is.  Under
    ``embed_split`` the table's embed dim stays split over "data" too (no
    gather of the table), and so do the rows: each rank takes its chunk of
    d of its vocabulary's rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab = {i for i, p in enumerate(table.placements) if isinstance(p, Shard) and p.dim == 0}
    split = {i for i in (EmbedSplit(mesh).dims if split_axes() else ())
             if table.placements[i].is_shard(1)}
    if isinstance(tokens, DTensor):
        tp = tuple(Replicate() if i in vocab else p for i, p in enumerate(tokens.placements))
        ids = tokens.redistribute(mesh, tp).to_local()
    else:
        tp, ids = replicated_placements(mesh), tokens
    tw = tuple(p if i in vocab or i in split else Replicate()
               for i, p in enumerate(table.placements))
    grad = tuple(p if i in vocab else Partial() if isinstance(tp[i], Shard) else Replicate()
                 for i, p in enumerate(tw))
    local = table.redistribute(mesh, tw).to_local(grad_placements=grad)
    (rows, _), (v0, _) = local_shape_and_offset(table.shape, mesh, tw)
    rel = ids.to(local.device, torch.long) - v0
    held = (rel >= 0) & (rel < rows)
    out = torch.where(held[..., None], local[rel.clamp(0, max(rows - 1, 0))], 0.0)
    tp = tuple(Shard(out.ndim - 1) if i in split else p for i, p in enumerate(tp))
    out = DTensor.from_local(out, mesh, tuple(Partial() if i in vocab else p
                                              for i, p in enumerate(tp)),
                             shape=(*tokens.shape, table.shape[1]),
                             stride=contiguous_strides((*tokens.shape, table.shape[1])))
    return out.redistribute(mesh, tp)


# --------------------------------------------------------------------- logits
def vocab_logits(h: torch.Tensor, w: torch.Tensor, cap: Optional[float] = None
                 ) -> torch.Tensor:
    """f32 logits (..., V) of ``h`` (..., d) against the table ``w`` (V, d):
    ``h @ w.T`` on 2-D rows in h's dtype (a strided (B, 1, d) slice would
    make ``matmul`` a batched product that reads the table once per row),
    then f32, soft-capped at ``cap``, placed as (batch, seq.., vocab).

    Under a mesh, with the vocabulary's axes not splitting the table (a
    table replicated because 16 does not divide seamless's 256206 rows),
    each rank computes only its own chunk of the vocabulary, ``h @ w[v0:
    v1].T``, in DTensor's chunks (16013 rows a rank, 16011 on the last), so
    the logits stay split over the vocabulary as the reference's constraint
    splits them.  h's gradient is then a partial sum over those axes and
    the table's a partial sum of the ranks' rows.  A table split over its
    rows gives the split logits through DTensor's own product.  Under
    ``embed_split`` each rank contracts its chunk of d (``_split_logits``)."""
    lead = ("batch",) + ("seq",) * (h.ndim - 2)
    mesh = get_mesh()
    on_mesh = mesh is not None and is_dtensor(h) and is_dtensor(w)
    vocab = [i for i, p in enumerate(placements(spec("vocab"), mesh))
             if p.is_shard() and mesh.size(i) > 1] if on_mesh else ()
    if on_mesh and split_axes():
        return _split_logits(h, w, cap, vocab)
    if not vocab or any(w.placements[i].is_shard(0) for i in vocab):
        return shard(vocab_chunk(h, w, cap), *lead, "vocab")
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = h.device_mesh
    hp = tuple(Replicate() if i in vocab else p for i, p in enumerate(h.placements))
    hl = h.redistribute(mesh, hp).to_local(
        grad_placements=tuple(Partial() if i in vocab else p for i, p in enumerate(hp)))
    rep = replicated_placements(mesh)
    wl = w.redistribute(mesh, rep).to_local(grad_placements=tuple(
        Partial() if i in vocab or p.is_shard() else Replicate() for i, p in enumerate(hp)))
    V = w.shape[0]
    op = tuple(Shard(h.ndim - 1) if i in vocab else p for i, p in enumerate(hp))
    (_, rows), (_, v0) = local_shape_and_offset((1, V), mesh, tuple(
        Shard(1) if i in vocab else Replicate() for i in range(len(hp))))
    shape = (*h.shape[:-1], V)
    return DTensor.from_local(vocab_chunk(hl, wl[v0:v0 + rows], cap), mesh, op, shape=shape,
                              stride=contiguous_strides(shape))


def _split_logits(h: torch.Tensor, w: torch.Tensor, cap: Optional[float], vocab
                  ) -> torch.Tensor:
    """``vocab_logits`` under ``embed_split``, with the table left as stored:
    each rank takes its own chunk of the vocabulary (the table's rows where
    the vocabulary's axes ``vocab`` split it, else ``w[v0:v1]`` as there),
    contracts its chunk of d against h's, and the f32 partial logits are
    summed over the batch axes before the soft cap.  The logits are split
    over the vocabulary as ``vocab_logits`` places them, whole over the
    batch axes.  (A decode step: no gradient.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = h.device_mesh
    sp = EmbedSplit(mesh)
    rep = replicated_placements(mesh)
    rows_split = any(w.placements[i].is_shard(0) for i in vocab)
    hl = h.redistribute(mesh, sp.placements(h.ndim - 1, rep)).to_local()
    wl = w.redistribute(mesh, sp.placements(1, tuple(
        p if i in vocab and rows_split else Replicate() for i, p in enumerate(w.placements))))
    wl = wl.to_local()
    V = w.shape[0]
    (_, rows), (_, v0) = local_shape_and_offset((1, V), mesh, tuple(
        Shard(1) if i in vocab else Replicate() for i in range(len(rep))))
    if not rows_split:
        wl = wl[v0:v0 + rows]
    out = softcap(sp.sum(vocab_chunk(hl, wl)), cap)
    shape = (*h.shape[:-1], V)
    return DTensor.from_local(out, mesh, tuple(Shard(h.ndim - 1) if i in vocab else Replicate()
                                               for i in range(len(rep))),
                              shape=shape, stride=contiguous_strides(shape))


def vocab_chunk(h: torch.Tensor, w: torch.Tensor, cap: Optional[float] = None
                ) -> torch.Tensor:
    """f32 logits (..., n) of ``h`` (..., d) against ``w`` (n, d), rows of
    a table: ``vocab_logits``'s product on one rank (the whole table, or
    the rank's own chunk of the vocabulary under a mesh)."""
    out = (h.reshape(-1, h.shape[-1]) @ w.T).reshape(*h.shape[:-1], w.shape[0])
    return softcap(out.float(), cap)


# ----------------------------------------------------------------------- loss
def ce_sum(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
           cap: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed cross entropy of the positions labelled >= 0, their count):
    logits ``h @ w.T`` in h's dtype (on 2-D rows), then in fp32 and soft-
    capped at ``cap``, as the reference's ``ce`` (``vocab_logits``)."""
    lse, gold = lse_gold(vocab_logits(h, w, cap), labels)
    valid = (labels >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def lse_gold(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp over the last dim, the logit at each label; 0 at a label
    < 0) of logits (..., V), as JAX's ``logsumexp`` computes it: the max, a
    constant shift without gradient, plus the log of the shifted exp-sum.
    DTensor logits whose vocabulary is sharded over some mesh axes stay on
    their shards: each rank takes its own columns, the max is maxed and the
    exp-sums and the label's logit (on the rank that holds it) are summed
    over those axes, and nothing of (..., V) is gathered.  On one rank the
    numbers are the plain tensor's, bit for bit."""
    def same(x: torch.Tensor) -> torch.Tensor:
        return x

    local, lab, v0, all_max, all_sum, shift = logits, labels, 0, same, same, same
    last = logits.ndim - 1
    if is_dtensor(logits) and any(p.is_shard(last) for p in logits.placements):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = logits.device_mesh
        vocab = {i for i, p in enumerate(logits.placements)
                 if isinstance(p, Shard) and p.dim == last}
        rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(logits.placements))
        local = logits.to_local(grad_placements=logits.placements)
        v0 = local_shape_and_offset(logits.shape, mesh, logits.placements)[1][last]
        if is_dtensor(labels):
            lab = labels.redistribute(mesh, rows).to_local()
        else:
            lead, off = local_shape_and_offset(labels.shape, mesh, rows)
            lab = labels[tuple(slice(o, o + n) for o, n in zip(off, lead))]

        def reduced(op: str):
            part = tuple(Partial(op) if i in vocab else p for i, p in enumerate(rows))
            return lambda x: DTensor.from_local(x, mesh, part).redistribute(mesh, rows)

        all_max, all_sum, shift = reduced("max"), reduced("sum"), lambda m: m.to_local()
    m = all_max(chunk_max(local))
    sums, gold = chunk_sum_gold(local, lab, v0, shift(m))
    return m + torch.log(all_sum(sums)), all_sum(gold)


def chunk_max(logits: torch.Tensor) -> torch.Tensor:
    """The max over the last dim of one rank's logits (..., n), without
    gradient: ``lse_gold``'s first local reduction, maxed over the ranks."""
    return logits.detach().amax(dim=-1)


def chunk_sum_gold(logits: torch.Tensor, labels: torch.Tensor, v0: int, m: torch.Tensor):
    """(the exp-sum of one rank's logits (..., n), columns v0..v0+n of the
    vocabulary, shifted by the max ``m`` over all ranks; the logit at each
    label that falls in those columns, 0 at the others): ``lse_gold``'s
    local reductions, each summed over the ranks."""
    cols = logits.shape[-1]
    rel = labels.to(logits.device, torch.long) - v0
    held = (rel >= 0) & (rel < cols)
    gold = torch.where(held, logits.gather(-1, rel.clamp(0, max(cols - 1, 0))[..., None])[..., 0],
                       0.0)
    return torch.exp(logits - m[..., None]).sum(dim=-1), gold


def whole_chunks_loss(hidden: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                      loss_chunk: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The hybrid's and the encoder-decoder's loss -> (nll, {"nll",
    "tokens"}): cross entropy over the whole chunks of ``min(loss_chunk,
    S)`` positions only.  Their references take ``hidden[:, :n_chunks *
    chunk]``, so the remainder's positions count for nothing (the decoder's
    loss keeps them)."""
    S = hidden.shape[1]
    chunk = min(loss_chunk, S)
    tot = cnt = torch.zeros((), device=hidden.device)
    for lo in range(0, S // chunk * chunk, chunk):
        t, n = ce_sum(hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk], w)
        tot, cnt = tot + t, cnt + n
    nll = tot / cnt.clamp_min(1.0)
    return nll, {"nll": nll, "tokens": cnt}


def remat_on(cfg) -> bool:
    """Whether ``cfg.remat`` recomputes each checkpointed unit in the
    backward: only under grad (a no-grad forward saves nothing)."""
    return cfg.remat != "none" and torch.is_grad_enabled()
