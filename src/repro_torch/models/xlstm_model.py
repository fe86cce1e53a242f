"""xLSTM language model (xlstm-125m): mLSTM blocks with periodic sLSTM.

Port of ``repro/models/xlstm_model.py``.  Blocks come in groups of
``slstm_every``: (slstm_every - 1) mLSTM blocks, then one sLSTM block.
Recurrent state replaces the KV cache, so decode cost and state are O(1) in
context length; the model has no attention and launches no attention
kernel.

Layers are ``nn.ModuleList``s: ``mlstm[g][j]`` is the reference's stacked
``mlstm`` row (g, j), ``slstm[g]`` its ``slstm`` row g.  The cache keeps the
reference's keys and layout (``mC``, ``mn``, ``mm``, ``mbuf`` over (G,
n_mlstm, ...); ``sh``, ``sc``, ``sn``, ``sm``, ``sbuf`` over (G, ...), all
fp32); ``decode_step`` updates it in place and ignores ``pos``.  The head is
tied to the embedding.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .layers import (
    activation_dtype,
    embed_apply,
    embed_init,
    frozen,
    param_dict,
    rms_norm,
    zeros_init,
)
from .xlstm import (
    mlstm_apply,
    mlstm_decode,
    mlstm_init,
    mlstm_prefill,
    mlstm_state_shapes,
    slstm_apply,
    slstm_decode,
    slstm_init,
    slstm_prefill,
    slstm_state_shapes,
)

_M_KEYS = ("mC", "mn", "mm")
_S_KEYS = ("sh", "sc", "sn", "sm")


class XBlock(nn.Module):
    """``ln`` and ``blk``: one row of the reference's ``mlstm`` or ``slstm``."""

    def __init__(self, params: dict, d_model: int, device):
        super().__init__()
        self.ln = frozen(zeros_init(d_model, device=device))
        self.blk = param_dict(params)


class XLSTMModel(nn.Module):
    """Weights drawn from ``seed`` on ``device`` (None: the CUDA card)."""

    def __init__(self, cfg, device: DeviceLike = None, *, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.period = cfg.slstm_every or cfg.n_layers
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.n_layers} layers do not fill groups of {self.period}")
        self.n_groups = cfg.n_layers // self.period
        self.n_mlstm = self.period - 1 if cfg.slstm_every else self.period
        self.dtype = activation_dtype(cfg)
        self.init(torch.Generator(device=self.device).manual_seed(seed))

    def init(self, gen: torch.Generator) -> None:
        cfg, dev, dt = self.cfg, self.device, self.dtype
        self.embed = frozen(embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev, dtype=dt))
        self.mlstm = nn.ModuleList(
            nn.ModuleList(XBlock(mlstm_init(gen, cfg, device=dev, dtype=dt), cfg.d_model, dev)
                          for _ in range(self.n_mlstm))
            for _ in range(self.n_groups))
        self.final_norm = frozen(zeros_init(cfg.d_model, device=dev))
        if cfg.slstm_every:
            self.slstm = nn.ModuleList(
                XBlock(slstm_init(gen, cfg, device=dev, dtype=dt), cfg.d_model, dev)
                for _ in range(self.n_groups))

    def _norm(self, x: torch.Tensor, b: XBlock) -> torch.Tensor:
        return rms_norm(x, b.ln, self.cfg.norm_eps)

    # --------------------------------------------------------------- forward
    def hidden_states(self, batch) -> torch.Tensor:
        """Full-sequence forward -> final-normed hidden (B, S, d_model)."""
        cfg = self.cfg
        x = embed_apply(self.embed, batch["tokens"], False, cfg.d_model)
        for g in range(self.n_groups):
            for b in self.mlstm[g]:
                x = x + mlstm_apply(b.blk, self._norm(x, b), cfg)
            if cfg.slstm_every:
                b = self.slstm[g]
                x = x + slstm_apply(b.blk, self._norm(x, b), cfg)
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        out = hidden.reshape(-1, hidden.shape[-1]) @ self.embed.to(hidden.dtype).T
        return out.reshape(*hidden.shape[:-1], out.shape[-1]).float()

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int = 0,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
        """The recurrent state; ``max_len`` and ``dtype`` are ignored (the
        state is O(1) in context and fp32)."""
        g, nm = self.n_groups, self.n_mlstm
        f32 = {"dtype": torch.float32, "device": self.device}
        mC, mn, mm, mbuf = mlstm_state_shapes(self.cfg, batch)
        cache = {"mC": torch.zeros((g, nm) + mC, **f32), "mn": torch.zeros((g, nm) + mn, **f32),
                 "mm": torch.full((g, nm) + mm, -1e30, **f32),
                 "mbuf": torch.zeros((g, nm) + mbuf, **f32)}
        if self.cfg.slstm_every:
            sh, sc, sn, sm, sbuf = slstm_state_shapes(self.cfg, batch)
            cache.update({"sh": torch.zeros((g,) + sh, **f32),
                          "sc": torch.zeros((g,) + sc, **f32),
                          "sn": torch.zeros((g,) + sn, **f32),
                          "sm": torch.full((g,) + sm, -10.0, **f32),
                          "sbuf": torch.zeros((g,) + sbuf, **f32)})
        return cache

    def prefill(self, batch, max_len: int = 0, cache_dtype: torch.dtype = torch.bfloat16):
        """Parallel prefill with the exact final recurrent states ->
        (last-position logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_apply(self.embed, tokens, False, cfg.d_model)
        cache = self.init_cache(tokens.shape[0], max_len, cache_dtype)
        for g in range(self.n_groups):
            for j, b in enumerate(self.mlstm[g]):
                y, state, buf = mlstm_prefill(b.blk, self._norm(x, b), cfg)
                x = x + y
                for key, t in zip(_M_KEYS + ("mbuf",), state + (buf,)):
                    cache[key][g, j] = t
            if cfg.slstm_every:
                b = self.slstm[g]
                y, state, buf = slstm_prefill(b.blk, self._norm(x, b), cfg)
                x = x + y
                for key, t in zip(_S_KEYS + ("sbuf",), state + (buf,)):
                    cache[key][g] = t
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.logits(x[:, -1:, :]), cache

    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], pos=None):
        """tokens (B, 1); ``pos`` is ignored.  Updates ``cache`` in place ->
        (logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens, False, cfg.d_model)
        for g in range(self.n_groups):
            for j, b in enumerate(self.mlstm[g]):
                state = tuple(cache[key][g, j] for key in _M_KEYS)
                y, state, buf = mlstm_decode(b.blk, self._norm(x, b), cfg, state,
                                             cache["mbuf"][g, j])
                x = x + y
                for key, t in zip(_M_KEYS + ("mbuf",), state + (buf,)):
                    cache[key][g, j] = t
            if cfg.slstm_every:
                b = self.slstm[g]
                state = tuple(cache[key][g] for key in _S_KEYS)
                y, state, buf = slstm_decode(b.blk, self._norm(x, b), cfg, state,
                                             cache["sbuf"][g])
                x = x + y
                for key, t in zip(_S_KEYS + ("sbuf",), state + (buf,)):
                    cache[key][g] = t
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.logits(x), cache
