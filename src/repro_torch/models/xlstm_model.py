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

``trainable=True`` builds the training construction, as ``DecoderLM``
does: fp32 masters that take gradients, cast at use.  ``loss`` is the
reference's: the cross entropy of the full logits (not chunked), no
auxiliary term; ``cfg.remat`` recomputes each group in the backward, as
the reference's ``_remat(group_body, cfg)`` (xlstm-125m's is "none").
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, generator, resolve_device
from .partitioning import at_use, batch_local, local_split, shard, split_decode, zeros
from .layers import (
    activation_dtype,
    ce_sum,
    embed_apply,
    embed_init,
    frozen,
    param_dict,
    remat_on,
    rms_norm,
    trainable_masters,
    vocab_logits,
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
    """Weights drawn from ``seed`` on ``device`` (None: the CUDA card);
    ``trainable``: fp32 masters that take gradients (else ``cfg.dtype``
    matrices without gradients, for serving)."""

    def __init__(self, cfg, device: DeviceLike = None, *, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.period = cfg.slstm_every or cfg.n_layers
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.n_layers} layers do not fill groups of {self.period}")
        self.n_groups = cfg.n_layers // self.period
        self.n_mlstm = self.period - 1 if cfg.slstm_every else self.period
        self.dtype = activation_dtype(cfg)
        self.init(generator(self.device, seed),
                  torch.float32 if trainable else self.dtype)
        if trainable:
            trainable_masters(self)

    def init(self, gen: torch.Generator, dt: torch.dtype) -> None:
        """Draw every weight from ``gen`` (the reference's distributions),
        matrices stored in ``dt``."""
        cfg, dev = self.cfg, self.device
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

    def _norm(self, x: torch.Tensor, b) -> torch.Tensor:
        """rms_norm by block ``b``'s ``ln`` (or by the scale ``b``)."""
        return rms_norm(x, b.ln if isinstance(b, XBlock) else b, self.cfg.norm_eps)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_apply(at_use(self.embed, self.dtype), tokens, False, self.cfg.d_model)

    def _group(self, g: int, x: torch.Tensor) -> torch.Tensor:
        """Group ``g``: its mLSTM blocks, then its sLSTM block."""
        cfg = self.cfg
        for b in self.mlstm[g]:
            y = batch_local(lambda x_, blk, ln: mlstm_apply(blk, self._norm(x_, ln), cfg),
                            x, dict(b.blk.items()), b.ln)
            x = shard(x + y, "batch", "seq", "embed")
        if cfg.slstm_every:
            b = self.slstm[g]
            x = x + batch_local(lambda x_, blk, ln: slstm_apply(blk, self._norm(x_, ln), cfg),
                                x, dict(b.blk.items()), b.ln)
        return x

    # --------------------------------------------------------------- forward
    def hidden_states(self, batch) -> torch.Tensor:
        """Full-sequence forward -> final-normed hidden (B, S, d_model).
        Under grad, ``cfg.remat`` recomputes each group in the backward."""
        x = shard(self._embed(batch["tokens"]), "batch", "seq", "embed")
        remat = remat_on(self.cfg)
        for g in range(self.n_groups):
            x = (checkpoint(self._group, g, x, use_reentrant=False) if remat
                 else self._group(g, x))
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return vocab_logits(hidden, at_use(self.embed, hidden.dtype))

    # ------------------------------------------------------------------ loss
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Causal LM loss over the full logits (tied head) -> (nll, {"nll",
        "tokens"}); ``batch["labels"]`` the next-token ids, -1 a pad."""
        hidden = self.hidden_states(batch)
        labels = batch["labels"].to(hidden.device, torch.long)
        tot, cnt = ce_sum(hidden, labels, at_use(self.embed, hidden.dtype))
        nll = tot / cnt.clamp_min(1.0)
        return nll, {"nll": nll, "tokens": cnt}

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
    def init_cache(self, batch: int, max_len: int = 0, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
        """The recurrent state on ``device`` (default: the model's);
        ``max_len`` and ``dtype`` are ignored (the state is O(1) in context
        and fp32); under a mesh, DTensors split over the batch."""
        g, nm = self.n_groups, self.n_mlstm
        f32 = {"dtype": torch.float32, "device": self.device if device is None else device}

        def state(lead, own, fill=0.0):   # the batch is the first of the state's own dims
            t = zeros(lead + own, "batch", *(None,) * (len(own) - 1), **f32)
            return t.fill_(fill) if fill else t

        mC, mn, mm, mbuf = mlstm_state_shapes(self.cfg, batch)
        cache = {"mC": state((g, nm), mC), "mn": state((g, nm), mn),
                 "mm": state((g, nm), mm, -1e30), "mbuf": state((g, nm), mbuf)}
        if self.cfg.slstm_every:
            sh, sc, sn, sm, sbuf = slstm_state_shapes(self.cfg, batch)
            cache.update({"sh": state((g,), sh), "sc": state((g,), sc), "sn": state((g,), sn),
                          "sm": state((g,), sm, -10.0), "sbuf": state((g,), sbuf)})
        return cache

    def cache_specs(self, batch: int, max_len: int = 0,
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
        """The state's keys, shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def prefill(self, batch, max_len: int = 0, cache_dtype: torch.dtype = torch.bfloat16):
        """Parallel prefill with the exact final recurrent states ->
        (last-position logits (B, 1, V) f32, cache); under a mesh each block
        on the rank's batch shard (``batch_local``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(tokens)
        cache = self.init_cache(tokens.shape[0], max_len, cache_dtype)
        for g in range(self.n_groups):
            for j, b in enumerate(self.mlstm[g]):
                y, state, buf = batch_local(
                    lambda x_, blk, ln: mlstm_prefill(blk, self._norm(x_, ln), cfg),
                    x, dict(b.blk.items()), b.ln)
                x = shard(x + y, "batch", "seq", "embed")
                for key, t in zip(_M_KEYS + ("mbuf",), state + (buf,)):
                    cache[key][g, j] = t
            if cfg.slstm_every:
                b = self.slstm[g]
                y, state, buf = batch_local(
                    lambda x_, blk, ln: slstm_prefill(blk, self._norm(x_, ln), cfg),
                    x, dict(b.blk.items()), b.ln)
                x = shard(x + y, "batch", "seq", "embed")
                for key, t in zip(_S_KEYS + ("sbuf",), state + (buf,)):
                    cache[key][g] = t
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.logits(x[:, -1:, :]), cache

    @split_decode
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], pos=None):
        """tokens (B, 1); ``pos`` is ignored.  Updates ``cache`` in place ->
        (logits (B, 1, V) f32, cache).  Under a mesh each block's step runs
        on the rank's batch shard of x and of its states
        (``partitioning.batch_local``).  Where the batch axes do not divide
        the batch (B = 1), the step runs under ``embed_split``: each rank
        takes x whole (its blocks' conv buffers and the recurrent products
        need it), contracts d over its rows of the weights that read it and
        makes its own chunk of d (``xlstm.mlstm_decode``'s ``split``), the
        weights only sliced (xLSTM's are replicated)."""
        cfg = self.cfg
        x = shard(self._embed(tokens), "batch", "seq", "embed")
        sp = local_split()
        for g in range(self.n_groups):
            for j, b in enumerate(self.mlstm[g]):
                state = tuple(cache[key][g, j] for key in _M_KEYS + ("mbuf",))
                y, state, buf = batch_local(
                    lambda x_, blk, ln, s: mlstm_decode(blk, self._norm(x_, ln), cfg, s[:-1],
                                                        s[-1], sp),
                    x, dict(b.blk.items()), b.ln, states=state, split=sp)
                x = x + y
                for key, t in zip(_M_KEYS + ("mbuf",), state + (buf,)):
                    cache[key][g, j] = t
            if cfg.slstm_every:
                b = self.slstm[g]
                state = tuple(cache[key][g] for key in _S_KEYS + ("sbuf",))
                y, state, buf = batch_local(
                    lambda x_, blk, ln, s: slstm_decode(blk, self._norm(x_, ln), cfg, s[:-1],
                                                        s[-1], sp),
                    x, dict(b.blk.items()), b.ln, states=state, split=sp)
                x = x + y
                for key, t in zip(_S_KEYS + ("sbuf",), state + (buf,)):
                    cache[key][g] = t
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.logits(x), cache
