"""AdamW with memory-efficient moment storage and gradient compression.

Port of ``repro/training/optimizer.py``:

* **Quantised moments**: m and v stored in float32, bfloat16 or int8 (per-row
  absmax scales over the last axis, round half to even, clipped to +-127).
* **Gradient compression with error feedback**: int8-quantised gradients
  with a residual accumulator (the numerics of a compressed all-reduce).
* **Global-norm clipping**, decoupled weight decay, cosine / linear /
  constant schedules with a linear warmup.

Parameters, gradients and moments are dicts keyed by parameter name (an
int8 moment is a ``{"q", "scale"}`` dict under its name).  The schedule,
the bias corrections and every update are float32 tensor arithmetic on the
parameters' device, as the reference computes them in jnp float32.  Unlike
the reference's pure functions, ``adamw_update`` updates the parameters and
the state in place (the port keeps one copy of the training state: at
qwen3-1.7b's width the fp32 masters and two moments alone are 20.6 GB).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

from ..models.partitioning import is_dtensor

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"        # float32 | bfloat16 | int8
    compress_grads: bool = False         # int8 + error feedback
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"             # cosine | linear | constant


# ------------------------------------------------------- int8 (de)quantisers
def _quantize(x: torch.Tensor) -> Tensors:
    """Per-row absmax int8 over the last axis: q = clip(round(x / scale),
    -127, 127) with scale = max|x| / 127 (at least 1e-12), float32."""
    scale = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequantize(d: Tensors) -> torch.Tensor:
    return d["q"].float() * d["scale"]


Moment = Union[torch.Tensor, Tensors]


def _store(x: torch.Tensor, dtype: str) -> Moment:
    if dtype == "int8":
        return _quantize(x)
    return x.to(getattr(torch, dtype))


def _load(x: Moment, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(x)
    return x.float()


# ------------------------------------------------------------------ schedule
def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a float32 tensor
    on the step's device: linear warmup, then the schedule's decay."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


# ------------------------------------------------------------------ optimizer
def adamw_init(params: Tensors, cfg: OptimizerConfig) -> Dict[str, Any]:
    """{"step": int32 0, "m", "v": zero moments keyed like ``params`` (and
    "error": fp32 zeros with ``compress_grads``)}."""
    def zeros():
        return {n: _store(torch.zeros_like(p, dtype=torch.float32), cfg.moment_dtype)
                for n, p in params.items()}

    device = next(iter(params.values())).device if params else None
    state = {"step": torch.zeros((), dtype=torch.int32, device=device), "m": zeros(),
             "v": zeros()}
    if cfg.compress_grads:
        state["error"] = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    return state


def _keep_layout(new: Tensors, old: Tensors) -> Tensors:
    """A new int8 moment with the placements of the one it replaces (under
    a mesh the state keeps its ``state_shardings`` layout)."""
    return {k: v.redistribute(old[k].device_mesh, old[k].placements)
            if is_dtensor(old[k]) and tuple(v.placements) != tuple(old[k].placements) else v
            for k, v in new.items()}


def _compress(g: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 round trip of g + e, the residual it leaves)."""
    t = g.float() + e
    gq = _dequantize(_quantize(t))
    return gq, t - gq


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: Dict[str, Any],
                 cfg: OptimizerConfig) -> Tuple[Tensors, Dict[str, Any], Tensors]:
    """One AdamW step -> (params, state, {"grad_norm", "lr"}).  ``params``
    and ``state`` are updated in place and returned; ``grads`` are read."""
    step = state["step"] + 1
    if cfg.compress_grads:   # error feedback, before the global reduce
        pairs = {n: _compress(g, state["error"][n]) for n, g in grads.items()}
        grads = {n: gq for n, (gq, _) in pairs.items()}
        for n, (_, err) in pairs.items():
            state["error"][n].copy_(err)
        del pairs

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    for n, p in params.items():
        g = grads[n].float() * clip
        mf = b1 * _load(state["m"][n], cfg.moment_dtype) + (1 - b1) * g
        vf = b2 * _load(state["v"][n], cfg.moment_dtype) + (1 - b2) * torch.square(g)
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        p.copy_(p.float() * (1 - lr * cfg.weight_decay) - lr * update)
        for key, x in (("m", mf), ("v", vf)):
            if cfg.moment_dtype == "int8":
                state[key][n] = _keep_layout(_quantize(x), state[key][n])
            else:
                state[key][n].copy_(x)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
