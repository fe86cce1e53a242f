"""Zamba2-style hybrid model: a Mamba2 backbone and one SHARED attention block.

Port of ``repro/models/hybrid.py``.  zamba2-7b: 81 Mamba2 layers; a single
shared (attention + MLP) block, one parameter set, is applied after every
``cfg.attn_every`` Mamba layers: G = n_layers // attn_every groups of
[attn_every x Mamba2, the shared block], then a tail of the remaining Mamba
layers (13 groups and a tail of 3 for zamba2-7b).  Each application of the
shared block sees other activations, so each keeps its own KV cache.

Layers are ``nn.ModuleList``s: ``main[g][p]`` is the reference's stacked
``main`` row (g, p), ``tail[t]`` its ``tail`` row t.  The cache keeps the
reference's keys and layout: ``ssm`` (G, P, B, H, P, N) and ``conv`` (G, P,
B, W-1, conv_dim) fp32, ``k``/``v`` (G, B, max_len, KV, D), ``ssm_tail`` and
``conv_tail``; ``decode_step`` updates it in place.  Every attention call is
K6 (prefill) or K7 (decode) through ``attention.py``.

``trainable=True`` builds the training construction, as ``DecoderLM``
does: fp32 masters that take gradients, cast at use.  The shared block's
masters collect the gradient of every application.  ``loss`` is the
reference's: the chunked cross entropy over whole chunks only (the
remainder is dropped) and no auxiliary term.  ``cfg.remat`` recomputes each
group (its Mamba2 layers and the shared block's application) in the
backward, as the reference's ``_remat(group_body, cfg)``; the tail layers
are not recomputed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, generator, resolve_device
from .attention import attention_apply, attention_decode, attention_init, attn_dims
from .partitioning import at_use, is_dtensor, shard, split_decode, write_slots, zeros
from .layers import (
    activation_dtype,
    embed_apply,
    embed_init,
    frozen,
    mlp_apply,
    mlp_init,
    param_dict,
    remat_on,
    rms_norm,
    trainable_masters,
    vocab_logits,
    whole_chunks_loss,
    zeros_init,
)
from .ssm import (
    CONV_WIDTH,
    _split_in,
    mamba2_apply,
    mamba2_decode,
    mamba2_init,
    mamba2_sharded,
    mamba2_state_shapes,
    ssm_dims,
)


class MambaLayer(nn.Module):
    """``ln`` and ``mamba``: one row of the reference's ``main``/``tail``."""

    def __init__(self, gen: torch.Generator, cfg, *, device, dtype: torch.dtype):
        super().__init__()
        self.ln = frozen(zeros_init(cfg.d_model, device=device))
        self.mamba = param_dict(mamba2_init(gen, cfg, device=device, dtype=dtype))


class SharedBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``: the reference's ``shared``."""

    def __init__(self, gen: torch.Generator, cfg, *, device, dtype: torch.dtype):
        super().__init__()
        self.ln1 = frozen(zeros_init(cfg.d_model, device=device))
        self.attn = param_dict(attention_init(gen, cfg, device=device, dtype=dtype))
        self.ln2 = frozen(zeros_init(cfg.d_model, device=device))
        self.mlp = param_dict(mlp_init(gen, cfg.d_model, cfg.d_ff, device=device,
                                       dtype=dtype))


class HybridModel(nn.Module):
    """Weights drawn from ``seed`` on ``device`` (None: the CUDA card);
    ``trainable``: fp32 masters that take gradients (else ``cfg.dtype``
    matrices without gradients, for serving)."""

    def __init__(self, cfg, device: DeviceLike = None, *, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.period = cfg.attn_every
        self.n_groups = cfg.n_layers // self.period
        self.n_tail = cfg.n_layers - self.n_groups * self.period
        self.dtype = activation_dtype(cfg)
        self.init(generator(self.device, seed),
                  torch.float32 if trainable else self.dtype)
        if trainable:
            trainable_masters(self)

    def init(self, gen: torch.Generator, dt: torch.dtype) -> None:
        """Draw every weight from ``gen`` (the reference's distributions),
        matrices stored in ``dt``."""
        cfg, kw = self.cfg, {"device": self.device, "dtype": dt}
        self.embed = frozen(embed_init(gen, cfg.vocab_size, cfg.d_model, **kw))
        self.main = nn.ModuleList(
            nn.ModuleList(MambaLayer(gen, cfg, **kw) for _ in range(self.period))
            for _ in range(self.n_groups))
        self.shared = SharedBlock(gen, cfg, **kw)
        self.final_norm = frozen(zeros_init(cfg.d_model, device=self.device))
        self.tail = nn.ModuleList(MambaLayer(gen, cfg, **kw) for _ in range(self.n_tail))
        if not cfg.tie_embeddings:
            self.head = frozen(embed_init(gen, cfg.vocab_size, cfg.d_model, **kw))

    def _shared_apply(self, x: torch.Tensor, positions: torch.Tensor, *,
                      return_kv: bool = False):
        cfg, p = self.cfg, self.shared
        h, kv = attention_apply(p.attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                                positions=positions, causal=True, return_kv=True)
        x = x + h
        x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.mlp_act)
        return (x, kv) if return_kv else x

    def _mamba(self, layer: MambaLayer, x: torch.Tensor) -> torch.Tensor:
        """One Mamba2 layer and its residual; on a mesh each rank computes
        its heads (``mamba2_sharded``)."""
        cfg, p = self.cfg, dict(layer.mamba.items())
        y = (mamba2_sharded(p, layer.ln, x, cfg, chunk=cfg.scan_chunk) if is_dtensor(x) else
             mamba2_apply(p, rms_norm(x, layer.ln, cfg.norm_eps), cfg, chunk=cfg.scan_chunk))
        return shard(x + y, "batch", "seq", "embed")

    def _group(self, group: nn.ModuleList, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        """One group: its Mamba2 layers, then the shared block."""
        for layer in group:
            x = self._mamba(layer, x)
        return self._shared_apply(x, positions)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_apply(at_use(self.embed, self.dtype), tokens, False, self.cfg.d_model)

    # --------------------------------------------------------------- forward
    def hidden_states(self, batch) -> torch.Tensor:
        """Full-sequence forward -> final-normed hidden (B, S, d_model).
        Under grad, ``cfg.remat`` recomputes each group in the backward."""
        x = shard(self._embed(batch["tokens"]), "batch", "seq", "embed")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat_on(self.cfg)
        for group in self.main:
            x = (checkpoint(self._group, group, x, positions, use_reentrant=False) if remat
                 else self._group(group, x, positions))
        for layer in self.tail:
            x = self._mamba(layer, x)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def _head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.head

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return vocab_logits(hidden, at_use(self._head(), hidden.dtype))

    # ------------------------------------------------------------------ loss
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Chunked-vocab causal LM loss over whole chunks -> (nll, {"nll",
        "tokens"}); ``batch["labels"]`` the next-token ids, -1 a pad."""
        hidden = self.hidden_states(batch)
        labels = batch["labels"].to(hidden.device, torch.long)
        return whole_chunks_loss(hidden, labels, at_use(self._head(), hidden.dtype),
                                 self.cfg.loss_chunk)

    def forward(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward, ``loss`` (for ``torch.func.functional_call``)."""
        return self.loss(batch)

    def input_specs(self, shape) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every model input of a ``ShapeSpec``: tokens
        and (train) labels, or one decode token."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind not in ("train", "prefill"):
            return {"tokens": ((B, 1), torch.int32)}
        specs = {"tokens": ((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((B, S), torch.int32)
        return specs

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
        """Zero states and KV caches on ``device`` (default: the model's);
        under a mesh, DTensors placed as ``launch/shardings.py::
        cache_shardings`` places them."""
        d = attn_dims(self.cfg)
        dev = self.device if device is None else device
        st, cb = mamba2_state_shapes(self.cfg, batch)
        gp = (self.n_groups, self.period)
        f32 = {"dtype": torch.float32, "device": dev}
        kv = (self.n_groups, batch, max_len, d.n_kv, d.head_dim)
        ssm_axes, conv_axes = ("batch", "heads", None, None), ("batch", None, "ff")
        kv_axes = ("batch", "kv_seq", "kv", "head_dim")
        cache = {"ssm": zeros(gp + st, *ssm_axes, **f32),
                 "conv": zeros(gp + cb, *conv_axes, **f32),
                 "k": zeros(kv, *kv_axes, dtype=dtype, device=dev),
                 "v": zeros(kv, *kv_axes, dtype=dtype, device=dev)}
        if self.n_tail:
            cache["ssm_tail"] = zeros((self.n_tail,) + st, *ssm_axes, **f32)
            cache["conv_tail"] = zeros((self.n_tail,) + cb, *conv_axes, **f32)
        return cache

    def cache_specs(self, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
        """The cache's keys, shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def _mamba_prefill(self, layer: MambaLayer, x: torch.Tensor, ssm: torch.Tensor,
                       conv: torch.Tensor) -> torch.Tensor:
        """One Mamba layer of the prompt; its final state goes to ``ssm`` and
        the pre-conv activations of the last W-1 positions to ``conv``; on a
        mesh each rank computes its heads and writes its own chunks of both
        (``mamba2_sharded``)."""
        cfg, p = self.cfg, dict(layer.mamba.items())
        if is_dtensor(x):
            return x + mamba2_sharded(p, layer.ln, x, cfg, chunk=cfg.scan_chunk, ssm=ssm,
                                      conv=conv)
        xn = rms_norm(x, layer.ln, cfg.norm_eps)
        y, hT = mamba2_apply(p, xn, cfg, chunk=cfg.scan_chunk, return_state=True)
        ssm.copy_(hT)
        conv.copy_(_split_in(p, xn[:, x.shape[1] - (CONV_WIDTH - 1):], ssm_dims(cfg))[1])
        return x + y

    def prefill(self, batch, max_len: int, cache_dtype: torch.dtype = torch.bfloat16):
        """Run the prompt, build the cache -> (last-position logits (B, 1, V)
        f32, cache)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(S, device=x.device)[None, :]
        cache = self.init_cache(B, max_len, cache_dtype)
        for g, group in enumerate(self.main):
            for p, layer in enumerate(group):
                x = self._mamba_prefill(layer, x, cache["ssm"][g, p], cache["conv"][g, p])
            x, (k, v) = self._shared_apply(x, positions, return_kv=True)
            write_slots(cache["k"][g], k, 0)
            write_slots(cache["v"][g], v, 0)
        for t, layer in enumerate(self.tail):
            x = self._mamba_prefill(layer, x, cache["ssm_tail"][t], cache["conv_tail"][t])
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(x[:, -1:, :]), cache

    def _mamba_step(self, layer: MambaLayer, x: torch.Tensor, ssm: torch.Tensor,
                    conv: torch.Tensor) -> torch.Tensor:
        """One Mamba layer's decode step; on a mesh each rank computes its
        heads from its state and its conv channels and writes its own chunks
        of both (``mamba2_sharded``)."""
        cfg, p = self.cfg, dict(layer.mamba.items())
        if is_dtensor(x):
            return x + mamba2_sharded(p, layer.ln, x, cfg, ssm=ssm, conv=conv, step=True)
        y, st, cb = mamba2_decode(p, rms_norm(x, layer.ln, cfg.norm_eps), cfg, ssm, conv)
        ssm.copy_(st)
        conv.copy_(cb)
        return x + y

    @split_decode
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], pos):
        """tokens (B, 1) at position ``pos`` (an int); updates ``cache`` in
        place -> (logits (B, 1, V) f32, cache).  Under a mesh whose batch
        axes do not divide the batch, the step runs under ``embed_split``
        (the reference's layout at batch 1)."""
        cfg, pos = self.cfg, int(pos)
        x = shard(self._embed(tokens), "batch", "seq", "embed")
        p = self.shared
        for g, group in enumerate(self.main):
            for j, layer in enumerate(group):
                x = self._mamba_step(layer, x, cache["ssm"][g, j], cache["conv"][g, j])
            h, _, _ = attention_decode(p.attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                                       cache["k"][g], cache["v"][g], pos)
            x = x + h
            x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.mlp_act)
        for t, layer in enumerate(self.tail):
            x = self._mamba_step(layer, x, cache["ssm_tail"][t], cache["conv_tail"][t])
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.logits(x), cache
