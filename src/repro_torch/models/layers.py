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

from .partitioning import shard

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
    """Gated MLP: SwiGLU (act='silu') or GeGLU (act='gelu', gemma)."""
    gate, up = (x @ params["wi"].to(x.dtype)).chunk(2, dim=-1)
    if act == "silu":
        g = F.silu(gate)
    elif act == "gelu":
        g = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return (g * up) @ params["wo"].to(x.dtype)


# ------------------------------------------------------------------ embedding
def embed_apply(table: torch.Tensor, tokens: torch.Tensor, scale: bool,
                d_model: int) -> torch.Tensor:
    x = table[tokens.to(table.device, torch.long)]
    if scale:  # gemma scales embeddings by sqrt(d_model)
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype, device=x.device)
    return x


# ----------------------------------------------------------------------- loss
def ce_sum(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
           cap: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed cross entropy of the positions labelled >= 0, their count):
    logits ``h @ w.T`` in h's dtype (on 2-D rows), then in fp32 and soft-
    capped at ``cap``, as the reference's ``ce``."""
    logits = (h.reshape(-1, h.shape[-1]) @ w.T).reshape(*h.shape[:-1], w.shape[0])
    logits = shard(softcap(logits.float(), cap), "batch", "seq", "vocab")
    # the gathered column is reduced over "vocab" before the last axis drops
    # (a vocab-sharded gather leaves a partial sum whose mask keeps the axis)
    gold = shard(logits.gather(-1, labels.clamp_min(0)[..., None]), "batch", "seq", None)[..., 0]
    valid = (labels >= 0).float()
    return ((torch.logsumexp(logits, dim=-1) - gold) * valid).sum(), valid.sum()


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
