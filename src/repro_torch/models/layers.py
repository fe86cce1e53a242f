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
    at_use,
    is_dtensor,
    local_shape_and_offset,
    relayout,
    replicated_placements,
    shard,
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
    these is a no-op for a plain tensor."""
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
    vocabulary: ``vocab_rows``)."""
    if is_dtensor(table) and any(p.is_shard(0) for p in table.placements):
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
    the axes that split the tokens, as a gathered batch's is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab = {i for i, p in enumerate(table.placements) if isinstance(p, Shard) and p.dim == 0}
    if isinstance(tokens, DTensor):
        tp = tuple(Replicate() if i in vocab else p for i, p in enumerate(tokens.placements))
        ids = tokens.redistribute(mesh, tp).to_local()
    else:
        tp, ids = replicated_placements(mesh), tokens
    tw = tuple(p if i in vocab else Replicate() for i, p in enumerate(table.placements))
    grad = tuple(p if i in vocab else Partial() if isinstance(tp[i], Shard) else Replicate()
                 for i, p in enumerate(tw))
    local = table.redistribute(mesh, tw).to_local(grad_placements=grad)
    (rows, _), (v0, _) = local_shape_and_offset(table.shape, mesh, tw)
    rel = ids.to(local.device, torch.long) - v0
    held = (rel >= 0) & (rel < rows)
    out = torch.where(held[..., None], local[rel.clamp(0, max(rows - 1, 0))], 0.0)
    out = DTensor.from_local(out, mesh, tuple(Partial() if i in vocab else p
                                              for i, p in enumerate(tp)))
    return out.redistribute(mesh, tp)


# ----------------------------------------------------------------------- loss
def ce_sum(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
           cap: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed cross entropy of the positions labelled >= 0, their count):
    logits ``h @ w.T`` in h's dtype (on 2-D rows), then in fp32 and soft-
    capped at ``cap``, as the reference's ``ce``."""
    logits = (h.reshape(-1, h.shape[-1]) @ w.T).reshape(*h.shape[:-1], w.shape[0])
    logits = shard(softcap(logits.float(), cap), "batch", "seq", "vocab")
    lse, gold = lse_gold(logits, labels)
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
    cols = local.shape[-1]
    rel = lab.to(local.device, torch.long) - v0
    held = (rel >= 0) & (rel < cols)
    gold = torch.where(held, local.gather(-1, rel.clamp(0, max(cols - 1, 0))[..., None])[..., 0],
                       0.0)
    m = all_max(local.detach().amax(dim=-1))
    sums = all_sum(torch.exp(local - shift(m)[..., None]).sum(dim=-1))
    return m + torch.log(sums), all_sum(gold)


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
