"""Encoder-decoder transformer for seamless-m4t-large-v2 ([audio]).

Port of ``repro/models/encdec.py``.  The speech frontend is a stub, as in
the reference: ``batch["frames"]`` holds precomputed frame embeddings (B,
S_enc, d_model); the transformer backbone (encoder, decoder with
cross-attention, tied head) is the reference's.

Every attention call goes through the kernel layer: the encoder's
self-attention is K6 without a causal mask, the decoder's self-attention K6
(prefill) and K7 (decode), and its cross-attention K6 at prefill (S decoder
positions against T encoder frames) and K7 at decode, against the whole
encoder memory (``kv_len`` = its length).  The reference computes the cross
attention with its plain ``attn_core``, the same function.

Layers are ``nn.ModuleList``s (row l of the reference's stacked
``enc_layers`` / ``dec_layers``).  The cache keeps the reference's keys and
layout: ``k``, ``v`` (L, B, max_len, KV, D) and ``xk``, ``xv`` (L, B, T_enc,
KV, D); ``decode_step`` updates it in place.

``trainable=True`` builds the training construction, as ``DecoderLM``
does: fp32 masters that take gradients, cast at use.  ``loss`` is the
reference's: encode ``frames``, run the decoder over ``tokens``, the
chunked cross entropy over whole chunks only (the remainder is dropped),
no auxiliary term.  ``cfg.remat`` recomputes each encoder layer and each
decoder layer in the backward, as the reference's ``_remat(body, cfg)``.
Train and prefill shapes split ``seq_len`` in two: S/2 frames, S/2 tokens.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, generator, resolve_device
from ..kernels import ops
from .partitioning import at_use, merge_heads, shard, split_decode, write_slots, zeros
from .attention import (
    _scale,
    attention_apply,
    attention_decode,
    attention_init,
    attn_dims,
    project_q,
)
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

ENC_MEMORY_LEN = 4_096  # the reference's encoder memory length for decode-shape cells


class EncLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg, *, device, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = frozen(zeros_init(d, device=device))
        self.attn = param_dict(attention_init(gen, cfg, device=device, dtype=dtype))
        self.ln2 = frozen(zeros_init(d, device=device))
        self.mlp = param_dict(mlp_init(gen, d, cfg.d_ff, device=device, dtype=dtype))


class DecLayer(nn.Module):
    """``ln1``, ``self_attn``, ``lnx``, ``cross_attn``, ``ln2``, ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg, *, device, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = frozen(zeros_init(d, device=device))
        self.self_attn = param_dict(attention_init(gen, cfg, device=device, dtype=dtype))
        self.lnx = frozen(zeros_init(d, device=device))
        self.cross_attn = param_dict(attention_init(gen, cfg, device=device, dtype=dtype))
        self.ln2 = frozen(zeros_init(d, device=device))
        self.mlp = param_dict(mlp_init(gen, d, cfg.d_ff, device=device, dtype=dtype))


class EncDecModel(nn.Module):
    """Weights drawn from ``seed`` on ``device`` (None: the CUDA card);
    ``trainable``: fp32 masters that take gradients (else ``cfg.dtype``
    matrices without gradients, for serving)."""

    def __init__(self, cfg, device: DeviceLike = None, *, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        if not (cfg.enc_layers and cfg.dec_layers):
            raise ValueError(f"{cfg.name} has no encoder and decoder layers")
        self.device = resolve_device(device)
        self.cfg = cfg
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
        self.enc_layers = nn.ModuleList(EncLayer(gen, cfg, **kw) for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(gen, cfg, **kw) for _ in range(cfg.dec_layers))
        self.enc_norm = frozen(zeros_init(cfg.d_model, device=self.device))
        self.dec_norm = frozen(zeros_init(cfg.d_model, device=self.device))

    # ---------------------------------------------------------------- encode
    def _enc_layer(self, p: EncLayer, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        x = x + attention_apply(p.attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                                positions=positions, causal=False)
        x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.mlp_act)
        return shard(x, "batch", "seq", "embed")

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, d_model) -> encoder memory (B, T, d_model).  Under
        grad, ``cfg.remat`` recomputes each layer in the backward."""
        x = shard(frames.to(self.device, self.dtype), "batch", "seq", "embed")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat_on(self.cfg)
        for p in self.enc_layers:
            x = (checkpoint(self._enc_layer, p, x, positions, use_reentrant=False) if remat
                 else self._enc_layer(p, x, positions))
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    # ---------------------------------------------------------------- decode
    def _dec_layer(self, p: DecLayer, x: torch.Tensor, memory: torch.Tensor,
                   positions: torch.Tensor):
        """One decoder layer over the whole prompt -> (x, (k, v), (xk, xv))."""
        cfg = self.cfg
        h, kv = attention_apply(p.self_attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                                positions=positions, causal=True, return_kv=True)
        x = x + h
        h, xkv = attention_apply(p.cross_attn, rms_norm(x, p.lnx, cfg.norm_eps), cfg,
                                 positions=positions, memory=memory, return_kv=True)
        x = x + h
        x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.mlp_act)
        return shard(x, "batch", "seq", "embed"), kv, xkv

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_apply(at_use(self.embed, self.dtype), tokens, False, self.cfg.d_model)

    def decode_full(self, tokens: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """The decoder over ``tokens`` (B, S) -> final-normed hidden.  Under
        grad, ``cfg.remat`` recomputes each layer in the backward."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat_on(self.cfg)
        for p in self.dec_layers:
            x = (checkpoint(self._dec_layer, p, x, memory, positions, use_reentrant=False)
                 if remat else self._dec_layer(p, x, memory, positions))[0]
        return rms_norm(x, self.dec_norm, self.cfg.norm_eps)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied head -> f32 logits."""
        return vocab_logits(hidden, at_use(self.embed, hidden.dtype))

    # ------------------------------------------------------------------ loss
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Encode ``batch["frames"]``, decode ``batch["tokens"]``: the
        chunked-vocab loss over whole chunks (tied head) -> (nll, {"nll",
        "tokens"}); ``batch["labels"]`` the next-token ids, -1 a pad."""
        hidden = self.decode_full(batch["tokens"], self.encode(batch["frames"]))
        labels = batch["labels"].to(hidden.device, torch.long)
        return whole_chunks_loss(hidden, labels, at_use(self.embed, hidden.dtype),
                                 self.cfg.loss_chunk)

    def forward(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward, ``loss`` (for ``torch.func.functional_call``)."""
        return self.loss(batch)

    def input_specs(self, shape) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every model input of a ``ShapeSpec``, in the
        reference's order: train and prefill take S/2 frame embeddings in
        ``cfg.dtype`` and S/2 tokens (train adds their labels); decode one
        token."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind not in ("train", "prefill"):
            return {"tokens": ((B, 1), torch.int32)}
        half = S // 2
        specs = {"frames": ((B, half, self.cfg.d_model), self.dtype),
                 "tokens": ((B, half), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((B, half), torch.int32)
        return specs

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, enc_len: int = ENC_MEMORY_LEN,
                   dtype: torch.dtype = torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
        """Zero self- and cross-attention caches on ``device`` (default: the
        model's); under a mesh, DTensors with their slots over "model" (the
        cross cache too), as ``launch/shardings.py::cache_shardings``
        places them."""
        d = attn_dims(self.cfg)
        L = self.cfg.dec_layers
        kw = {"dtype": dtype, "device": self.device if device is None else device}
        axes = ("batch", "kv_seq", "kv", "head_dim")
        return {"k": zeros((L, batch, max_len, d.n_kv, d.head_dim), *axes, **kw),
                "v": zeros((L, batch, max_len, d.n_kv, d.head_dim), *axes, **kw),
                "xk": zeros((L, batch, enc_len, d.n_kv, d.head_dim), *axes, **kw),
                "xv": zeros((L, batch, enc_len, d.n_kv, d.head_dim), *axes, **kw)}

    def cache_specs(self, batch: int, max_len: int, enc_len: int = ENC_MEMORY_LEN,
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
        """The caches' keys, shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, enc_len, dtype, device="meta")

    def prefill(self, batch, max_len: int, cache_dtype: torch.dtype = torch.bfloat16):
        """Encode ``batch["frames"]`` and run the decoder prompt; build the
        self- and cross-attention caches -> (last-position logits (B, 1, V)
        f32, cache)."""
        memory = self.encode(batch["frames"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(S, device=x.device)[None, :]
        cache = self.init_cache(B, max_len, memory.shape[1], cache_dtype)
        for layer, p in enumerate(self.dec_layers):
            x, (k, v), (xk, xv) = self._dec_layer(p, x, memory, positions)
            for name, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
                write_slots(cache[name][layer], t, 0)
        x = rms_norm(x, self.dec_norm, self.cfg.norm_eps)
        return self.logits(x[:, -1:, :]), cache

    @split_decode
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], pos):
        """tokens (B, 1) at position ``pos`` (an int); updates the self-
        attention cache in place -> (logits (B, 1, V) f32, cache).  Under a
        mesh whose batch axes do not divide the batch, the step runs under
        ``embed_split`` (the reference's layout at batch 1)."""
        cfg, pos = self.cfg, int(pos)
        x = shard(self._embed(tokens), "batch", "seq", "embed")
        B = x.shape[0]
        pos_b = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        enc_len = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32, device=x.device)
        for layer, p in enumerate(self.dec_layers):
            h, _, _ = attention_decode(p.self_attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                                       cache["k"][layer], cache["v"][layer], pos)
            x = x + h
            q = project_q(p.cross_attn, rms_norm(x, p.lnx, cfg.norm_eps), cfg, pos_b)
            out = ops.decode_attention(q[:, 0], cache["xk"][layer], cache["xv"][layer],
                                       enc_len, softcap=getattr(cfg, "attn_logit_softcap", None),
                                       scale=_scale(cfg, q.shape[-1]))
            x = x + shard(merge_heads(out[:, None]) @ at_use(p.cross_attn["wo"], x.dtype),
                          "batch", "seq", "embed")
            x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), cfg.mlp_act)
        x = rms_norm(x, self.dec_norm, cfg.norm_eps)
        return self.logits(x), cache
