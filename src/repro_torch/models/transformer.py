"""Decoder-only transformer LM for the dense, MoE and vision families.

Port of ``repro/models/transformer.py::DecoderLM``: init,
``hidden_states``, ``logits``, the chunked-vocab ``loss``, ``input_specs``,
and for serving ``prefill`` and ``decode_step`` with ring-buffer KV caches
(sliding-window layers allocate only ``window`` slots).  MoE
blocks (``cfg.n_experts > 0``) hold a ``moe`` (``moe.MoEParams``) in place
of ``mlp``; the vision families prepend ``batch["patch_embeds"]`` to the
text (early fusion), so their decode writes position ``S + patches``.

Layers are an ``nn.ModuleList`` in depth order instead of the reference's
scanned groups: layer ``g * len(pattern) + i`` is group ``g``'s variant
``i``.  The cache keeps the reference's layout, ``{"k{i}", "v{i}"}`` of
shape (n_groups, B, W, KV, D), so a JAX cache converts directly
(``convert.cache_from_jax``).

The reference keeps fp32 master weights and casts them at each use
(``x @ w.astype(x.dtype)``); for serving the port stores each matrix once in
``cfg.dtype``, which gives the same numbers and half the memory, and its
parameters take no gradient.  ``trainable=True`` builds the training
construction instead: every parameter an fp32 master that requires grad,
cast at use as the reference does (the forward's numbers are the
reference's).  Norm scales and the MoE router stay fp32 in both.

``cfg.remat`` ("block" or "full") recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant): both policies recompute the
whole block here, where the reference's "block" keeps its matmul outputs.
The policy changes time and memory, not numbers (the kernels are
deterministic, so a recomputed block gives the same bits).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, generator, resolve_device
from .attention import attention_apply, attention_decode, attention_init, attn_dims
from .layers import (
    activation_dtype,
    add_rms_norm,
    ce_sum,
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
    zeros_init,
)
from .moe import MoEParams, moe_apply
from .partitioning import (
    at_use,
    embed_whole,
    shard,
    split_axes,
    split_decode,
    write_slots,
    zeros,
)

AUX_LOSS_COEF = 0.01


# -------------------------------------------------------------------- variants
def variants_for(cfg) -> Tuple[Dict[str, Any], ...]:
    return tuple({"window": cfg.sliding_window if kind == "local" else None,
                  "moe": cfg.n_experts > 0} for kind in cfg.layer_pattern)


# ---------------------------------------------------------------------- blocks
class Block(nn.Module):
    """One pre-norm block: ``ln1``, ``attn``, ``ln2``, ``mlp`` or ``moe``
    (and gemma2's ``pn1``/``pn2`` post-norms), named as the reference's
    parameter tree."""

    def __init__(self, gen: torch.Generator, cfg, *, device, dtype: torch.dtype,
                 moe: bool = False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = frozen(zeros_init(d, device=device))
        self.attn = param_dict(attention_init(gen, cfg, device=device, dtype=dtype))
        self.ln2 = frozen(zeros_init(d, device=device))
        if moe:
            self.moe = MoEParams(gen, cfg, device=device, dtype=dtype)
        else:
            self.mlp = param_dict(mlp_init(gen, cfg.d_model, cfg.d_ff, device=device,
                                           dtype=dtype))
        if cfg.use_post_norms:
            self.pn1 = frozen(zeros_init(d, device=device))
            self.pn2 = frozen(zeros_init(d, device=device))


def block_apply(blk: Block, x: torch.Tensor, cfg, variant, positions: torch.Tensor, *,
                return_kv: bool = False):
    """-> (x, (k, v) or None, aux); aux is the MoE loss, 0 for an MLP."""
    eps = cfg.norm_eps
    a_in = rms_norm(x, blk.ln1, eps)
    kv = None
    if return_kv:
        attn_out, kv = attention_apply(blk.attn, a_in, cfg, positions=positions,
                                       window=variant["window"], return_kv=True)
    else:
        attn_out = attention_apply(blk.attn, a_in, cfg, positions=positions,
                                   window=variant["window"])
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, blk.pn1, eps)
    h, x = add_rms_norm(attn_out, x, blk.ln2, eps)     # x + attn_out and its norm
    mlp_out, aux = _ffn(blk, h, cfg, variant)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, blk.pn2, eps)
    return shard(x + mlp_out, "batch", "seq", "embed"), kv, aux


def _ffn(blk: Block, x: torch.Tensor, cfg, variant):
    if variant["moe"]:
        if not split_axes():
            return moe_apply(blk.moe, x, cfg)
        # an MoE block keeps its own layout under embed_split: x whole over
        # its embed dim in, the output back to the split
        with embed_whole():
            y, aux = moe_apply(blk.moe, shard(x, "batch", "seq", "embed"), cfg)
        return shard(y, "batch", "seq", "embed"), aux
    return mlp_apply(blk.mlp, x, cfg.mlp_act), 0.0


def block_decode(blk: Block, x: torch.Tensor, cfg, variant, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int):
    eps = cfg.norm_eps
    attn_out, k_cache, v_cache = attention_decode(
        blk.attn, rms_norm(x, blk.ln1, eps), cfg, k_cache, v_cache, pos)
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, blk.pn1, eps)
    h, x = add_rms_norm(attn_out, x, blk.ln2, eps)
    mlp_out, _ = _ffn(blk, h, cfg, variant)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, blk.pn2, eps)
    return x + mlp_out, k_cache, v_cache


# ----------------------------------------------------------------------- model
class DecoderLM(nn.Module):
    """Dense / MoE / early-fusion-VLM decoder language model, weights drawn
    from ``seed`` on ``device`` at construction.  ``device=None`` is the CUDA
    card; without one it raises unless ``device="cpu"``.  ``trainable``:
    fp32 master parameters that require grad (else ``cfg.dtype`` matrices
    without gradients, for serving)."""

    def __init__(self, cfg, device: DeviceLike = None, *, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.variants = variants_for(cfg)
        self.group = len(self.variants)
        if cfg.n_layers % self.group:
            raise ValueError(f"{cfg.n_layers} layers do not fill groups of {self.group}")
        self.n_groups = cfg.n_layers // self.group
        self.dtype = activation_dtype(cfg)
        self.init(generator(self.device, seed),
                  torch.float32 if trainable else self.dtype)
        if trainable:
            trainable_masters(self)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, dt: torch.dtype) -> None:
        """Draw every weight from ``gen``: matrices normal / sqrt(in) and
        embeddings normal * 0.02, stored in ``dt``; norm scales zero (the
        reference's distributions)."""
        cfg, dev = self.cfg, self.device
        self.embed = frozen(embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev, dtype=dt))
        self.final_norm = frozen(zeros_init(cfg.d_model, device=dev))
        if not cfg.tie_embeddings:
            self.head = frozen(embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev,
                                           dtype=dt))
        self.layers = nn.ModuleList(
            Block(gen, cfg, device=dev, dtype=dt, moe=self.variant_of(layer)["moe"])
            for layer in range(cfg.n_layers))

    def variant_of(self, layer: int) -> Dict[str, Any]:
        return self.variants[layer % self.group]

    # ------------------------------------------------------------- embedding
    def _embed_inputs(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        # the table cast first, as the reference casts it (a no-op for serving;
        # in training the gather's backward then sums in cfg.dtype, as there)
        x = embed_apply(at_use(self.embed, self.dtype), batch["tokens"], cfg.scale_embeddings,
                        cfg.d_model)
        if cfg.frontend is not None and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x), x], dim=1)   # early fusion
        x = shard(x, "batch", "seq", "embed")
        return x, torch.arange(x.shape[1], device=x.device)[None, :]

    # --------------------------------------------------------------- forward
    def hidden_states(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (final-normed hidden, summed aux loss).
        Under grad, ``cfg.remat`` recomputes each block in the backward."""
        x, positions = self._embed_inputs(batch)
        aux = torch.zeros((), device=x.device)
        remat = remat_on(self.cfg)
        for layer, blk in enumerate(self.layers):
            args = (blk, x, self.cfg, self.variant_of(layer), positions)
            x, _, a = (checkpoint(block_apply, *args, use_reentrant=False) if remat
                       else block_apply(*args))
            aux = aux + a
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x, aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., d_model) -> (..., vocab) f32.  The product runs on 2-D
        rows: a strided (B, 1, d) slice would make ``matmul`` a batched
        product that reads the whole (vocab, d) table once per row."""
        w = self.embed if self.cfg.tie_embeddings else self.head
        return vocab_logits(hidden, at_use(w, hidden.dtype), self.cfg.final_logit_softcap)

    # ------------------------------------------------------------------ loss
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Chunked-vocab causal LM loss -> (nll + AUX_LOSS_COEF * aux, {"nll",
        "aux", "tokens"}).  ``batch["labels"]`` are the next-token ids, -1 a
        pad; a vision model's patch positions take label -1.  The logits
        are taken ``cfg.loss_chunk`` positions at a time (then the
        remainder), so (B, S, vocab) is never held at once in the forward."""
        cfg = self.cfg
        hidden, aux = self.hidden_states(batch)
        labels = batch["labels"].to(hidden.device, torch.long)
        if cfg.frontend is not None and "patch_embeds" in batch:
            pad = labels.new_full((labels.shape[0], batch["patch_embeds"].shape[1]), -1)
            labels = torch.cat([pad, labels], dim=1)
        S = hidden.shape[1]
        chunk = min(cfg.loss_chunk, S)
        w = at_use(self.embed if cfg.tie_embeddings else self.head, hidden.dtype)
        tot = cnt = torch.zeros((), device=hidden.device)
        for lo in range(0, S, chunk):   # the whole chunks, then the remainder
            t, n = ce_sum(hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk], w,
                          cfg.final_logit_softcap)
            tot, cnt = tot + t, cnt + n
        nll = tot / cnt.clamp_min(1.0)
        return nll + AUX_LOSS_COEF * aux, {"nll": nll, "aux": aux, "tokens": cnt}

    def forward(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward, ``loss`` (so that ``torch.func.functional_call``
        runs the model on other parameter tensors)."""
        return self.loss(batch)

    def input_specs(self, shape) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every model input of a ``ShapeSpec``: tokens and
        (train) labels of the text positions, a vision model's patch
        embeddings, or one decode token."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        n_front = cfg.n_frontend_tokens if cfg.frontend else 0
        if shape.kind not in ("train", "prefill"):
            return {"tokens": ((B, 1), torch.int32)}
        specs = {"tokens": ((B, S - n_front), torch.int32)}
        if n_front:
            specs["patch_embeds"] = ((B, n_front, cfg.d_model), self.dtype)
        if shape.kind == "train":
            specs["labels"] = ((B, S - n_front), torch.int32)
        return specs

    # --------------------------------------------------------------- serving
    def cache_window(self, variant, max_len: int) -> int:
        w = variant["window"]
        return min(w, max_len) if w else max_len

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
        """Zero KV caches on ``device`` (default: the model's); under a mesh,
        DTensors placed as ``launch/shardings.py::cache_shardings`` places
        them (batch over the data axes, slots over "model")."""
        d = attn_dims(self.cfg)
        dev = self.device if device is None else device
        cache = {}
        for i, variant in enumerate(self.variants):
            shp = (self.n_groups, batch, self.cache_window(variant, max_len), d.n_kv,
                   d.head_dim)
            for name in (f"k{i}", f"v{i}"):
                cache[name] = zeros(shp, "batch", "kv_seq", "kv", "head_dim", dtype=dtype,
                                    device=dev)
        return cache

    def cache_specs(self, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
        """The cache's keys, shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def prefill(self, batch, max_len: int, cache_dtype: torch.dtype = torch.bfloat16):
        """Run the prompt, build the KV cache, return (last-position logits
        (B, 1, V) f32, cache).  Position p lives at slot p when the window
        W >= S; with W < S the cache keeps the last W positions at slots
        p % W (the ring)."""
        x, positions = self._embed_inputs(batch)
        B, S, _ = x.shape
        cache = self.init_cache(B, max_len, cache_dtype)
        for layer, blk in enumerate(self.layers):
            x, (k, v), _ = block_apply(blk, x, self.cfg, self.variant_of(layer), positions,
                                       return_kv=True)
            i, g = layer % self.group, layer // self.group
            for name, t in ((f"k{i}", k), (f"v{i}", v)):
                W = cache[name].shape[2]
                if W < S:   # the last W positions, position p at slot p % W
                    r = S % W
                    t = torch.cat([t[:, S - r:], t[:, S - W:S - r]], dim=1)
                write_slots(cache[name][g], t, 0)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(x[:, -1:, :]), cache

    @split_decode
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], pos):
        """tokens (B, 1); ``pos`` the position being written (an int).
        Updates ``cache`` in place and returns (logits (B, 1, V) f32,
        cache).  Under a mesh whose batch axes do not divide the batch, the
        step runs under ``embed_split`` (the reference's layout at batch 1)."""
        pos = int(pos)
        x = embed_apply(at_use(self.embed, self.dtype), tokens, self.cfg.scale_embeddings,
                        self.cfg.d_model)
        x = shard(x, "batch", "seq", "embed")
        for layer, blk in enumerate(self.layers):
            i, g = layer % self.group, layer // self.group
            kc = shard(cache[f"k{i}"][g], "batch", "kv_seq", "kv", "head_dim")
            vc = shard(cache[f"v{i}"][g], "batch", "kv_seq", "kv", "head_dim")
            x, _, _ = block_decode(blk, x, self.cfg, self.variant_of(layer), kc, vc, pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(x), cache
