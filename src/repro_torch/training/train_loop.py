"""Training step construction: microbatched gradient accumulation + AdamW.

Port of ``repro/training/train_loop.py``.  ``make_train_step(model, ocfg,
microbatches)`` returns ``train_step(state, batch) -> (state, metrics)``.
The state is ``{"params": {name: fp32 master}, "opt": adamw state}``;
``init_state`` takes the masters from a model built with ``trainable=True``
(the same tensors, not a copy), and the step updates them in place.

The gradient is taken of ``model.loss`` run on the state's parameters
(``torch.func.functional_call``, with the backward inside the call so that
``cfg.remat``'s recomputation sees the same tensors).  Attention's gradient
is K6's backward (``kernels/flash_attention.py::FlashAttention``).
Microbatching splits the batch along axis 0 and sums the microbatches' fp32
gradients, then divides, as the reference's scan does; activation memory
scales with the microbatch.  ``compute_dtype="bfloat16"`` takes a bf16
working copy of each >= 2-D fp32 master once per step and takes the
gradient with respect to that copy, as the reference does.

Under a mesh of two ranks or more the state's tensors are DTensors
(``launch/shardings.py``: ``distribute`` with ``state_shardings``; on one
rank it leaves them plain) and the batch is distributed with
``batch_shardings``; the model runs on them as written, and K6 runs on
each rank's shards.  ``grad_shardings`` (the parameters' placements, as
``state_shardings(...)["params"]`` gives them) redistributes each
microbatch's gradients to the parameter sharding before they are summed,
as the reference constrains them (``with_sharding_constraint``): with FSDP
placements the sum is then a reduce-scatter, not an all-reduce.  The loss
and metrics come back as plain tensors, equal on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch import nn
from torch.distributed.tensor.experimental import implicit_replication
from torch.func import functional_call

from ..models.partitioning import is_dtensor, replicated_placements, whole
from .optimizer import OptimizerConfig, adamw_init, adamw_update

TrainState = Dict[str, Any]   # {"params", "opt"}


def init_state(model: nn.Module, ocfg: OptimizerConfig) -> TrainState:
    """The training state of ``model`` (built with ``trainable=True``): its
    own parameter tensors as the masters, and fresh AdamW state."""
    params = {name: p.detach() for name, p in model.named_parameters()}
    bad = [n for n, p in params.items() if p.dtype != torch.float32]
    if bad:
        raise ValueError(f"train fp32 masters (build the model with trainable=True): {bad[:3]}")
    return {"params": params, "opt": adamw_init(params, ocfg)}


class _LossGrads(nn.Module):
    """``model.loss`` and its gradients with respect to the tensors the model
    is run on: both inside one ``functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, wrt):
        # the plain tensors the model makes (positions, rotary tables) are the
        # same on every rank: DTensor ops take them as replicated
        with implicit_replication():
            loss, metrics = self.model.loss(batch)
            if is_dtensor(loss):   # one value on every rank: its gradient seed is 1, once
                loss = loss.redistribute(loss.device_mesh, replicated_placements(loss.device_mesh))
            grads = torch.autograd.grad(loss, wrt)
        return whole(loss.detach()), {k: whole(v.detach()) for k, v in metrics.items()}, grads


def make_train_step(model: nn.Module, ocfg: OptimizerConfig, microbatches: int = 1,
                    grad_shardings: Optional[Dict[str, Any]] = None,
                    compute_dtype: Optional[str] = None):
    """-> ``train_step(state, batch) -> (state, metrics)``: ``metrics`` holds
    "loss", "grad_norm" and "lr" (0-d tensors), and with one microbatch the
    model's "nll", "aux" and "tokens".  ``grad_shardings``: {parameter name:
    placements} for DTensor gradients (see the module docstring)."""
    runner = _LossGrads(model)

    def constrain(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if grad_shardings is None:
            return grads
        return {n: g.redistribute(g.device_mesh, tuple(grad_shardings[n]))
                if is_dtensor(g) and tuple(g.placements) != tuple(grad_shardings[n]) else g
                for n, g in grads.items()}

    def working(master: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        dt = None if compute_dtype is None else getattr(torch, compute_dtype)
        out = {}
        for name, p in master.items():
            p = p.detach()
            if dt is not None and p.dtype == torch.float32 and p.dim() >= 2:
                p = p.to(dt)
            out[name] = p.requires_grad_(True)
        return out

    def grad_fn(params: Dict[str, torch.Tensor], batch):
        loss, metrics, grads = functional_call(
            runner, {f"model.{n}": t for n, t in params.items()},
            (batch, tuple(params.values())))
        return loss, metrics, constrain(dict(zip(params, grads)))

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        master = state["params"]
        params = working(master)   # a bf16 working copy with compute_dtype (see above)
        if microbatches <= 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            def split(x: torch.Tensor, i: int) -> torch.Tensor:
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
                n = b // microbatches
                if not is_dtensor(x):
                    return x[i * n:(i + 1) * n]
                # rows [i n, (i + 1) n), as the reference's reshape takes them,
                # sharded as the batch was: the (small) inputs are gathered
                # over the batch axes first, as a slice of a sharded dim would be
                mesh, placed = x.device_mesh, tuple(x.placements)
                whole_b = tuple(Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                                for p in placed)
                part = x.redistribute(mesh, whole_b)[i * n:(i + 1) * n]
                shards = math.prod(mesh.size(d) for d, p in enumerate(placed)
                                   if isinstance(p, Shard) and p.dim == 0)
                return part.redistribute(mesh, placed) if n % shards == 0 else part

            grads = {}
            loss = torch.zeros((), device=next(iter(master.values())).device)
            for i in range(microbatches):
                l_i, _, g = grad_fn(params, {k: split(x, i) for k, x in batch.items()})
                for n, gi in g.items():
                    if n not in grads:   # fp32 zeros with the gradient's placements
                        grads[n] = torch.zeros_like(gi, dtype=torch.float32)
                    grads[n] += gi
                loss = loss + l_i
                del g
            for g in grads.values():
                g /= microbatches
            loss = loss / microbatches
            metrics = {}
        del params
        _, _, opt_metrics = adamw_update(master, grads, state["opt"], ocfg)
        return state, {"loss": loss, **{k: whole(v) for k, v in opt_metrics.items()},
                       **metrics}

    return train_step


def make_eval_step(model: nn.Module):
    """-> ``eval_step(params, batch) -> {"loss", "nll", "aux", "tokens"}``,
    the model run on ``params`` (name -> tensor) without gradients."""
    def eval_step(params: Dict[str, torch.Tensor], batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, metrics = functional_call(model, params, (batch,))
        return {"loss": loss, **metrics}

    return eval_step
