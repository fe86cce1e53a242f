"""The model's weights, made from ``--seed`` on the device.

Both sides take these values: the benchmark copies them into the port's
model (``convert.load_params``) before the window, and the plain reference
makes them again, a layer at a time, after it.  Each group (the embedding,
the head, the final norm, one layer) has a generator of its own, seeded
from the run's seed and the group's index, so a group can be made alone and
in any order.  A group is two draws: one for its matrices and biases in the
dtype they are served in, one for its norm scales in float32 (the port keeps
norm scales in float32).

Names are the port's parameter names (``DecoderLM.named_parameters()``);
norm scales are the zero-centred ``scale`` of ``y * (1 + scale)``.
"""
from __future__ import annotations

import collections.abc
import math
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
EMBED_STD = 0.02      # the embedding and the untied head
BIAS_STD = 0.1
NORM_STD = 0.1        # a norm's weight is 1 + N(0, NORM_STD^2)

# purposes a run's seed is split into (SeedSequence's second word)
PURPOSE = {"weights": 1, "traffic": 2, "fill": 3, "prompts": 4, "sample": 5}


def sub_seed(seed: int, purpose: str, *words: int) -> int:
    """A 63-bit seed for one use of the run's seed (which may exceed 32
    bits): numpy's SeedSequence of (seed, purpose, words...)."""
    state = np.random.SeedSequence([int(seed), PURPOSE[purpose], *map(int, words)])
    a, b = state.generate_state(2, np.uint32)
    return ((int(a) << 32) | int(b)) & ((1 << 63) - 1)


def torch_generator(seed: int, purpose: str, device: torch.device, *words: int
                    ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose, *words))


# one leaf: (name, shape, kind) with kind "matrix" (std 1/sqrt(rows)),
# "embed", "bias" or "norm"
Leaf = Tuple[str, Tuple[int, ...], str]


def groups(m: Mapping) -> List[Tuple[str, List[Leaf]]]:
    """The port's dense decoder parameters, in groups, from a configuration
    (the configuration files' keys)."""
    d, v, ff = m["hidden_size"], m["vocab_size"], m["intermediate_size"]
    h, kv, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    out: List[Tuple[str, List[Leaf]]] = [("embed", [("embed", (v, d), "embed")]),
                                         ("final_norm", [("final_norm", (d,), "norm")])]
    if not m["tie_word_embeddings"]:
        out.append(("head", [("head", (v, d), "embed")]))
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i}."
        leaves: List[Leaf] = [(p + "ln1", (d,), "norm"), (p + "ln2", (d,), "norm"),
                              (p + "attn.wq", (d, h * hd), "matrix"),
                              (p + "attn.wk", (d, kv * hd), "matrix"),
                              (p + "attn.wv", (d, kv * hd), "matrix"),
                              (p + "attn.wo", (h * hd, d), "matrix"),
                              (p + "mlp.wi", (d, 2 * ff), "matrix"),
                              (p + "mlp.wo", (ff, d), "matrix")]
        if m["attention_bias"]:
            leaves += [(p + "attn.bq", (h * hd,), "bias"), (p + "attn.bk", (kv * hd,), "bias"),
                       (p + "attn.bv", (kv * hd,), "bias")]
        if m["qk_norm"]:
            leaves += [(p + "attn.q_norm", (hd,), "norm"), (p + "attn.k_norm", (hd,), "norm")]
        out.append((f"layers.{i}", leaves))
    return out


def make_group(leaves: List[Leaf], seed: int, index: int, device: torch.device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One group's tensors: a draw of every matrix and bias in ``dtype``, a
    draw of every norm scale in float32, each scaled in place."""
    gen = torch_generator(seed, "weights", device, index)
    wide = [lf for lf in leaves if lf[2] != "norm"]
    norms = [lf for lf in leaves if lf[2] == "norm"]
    out: Dict[str, torch.Tensor] = {}
    for part, dt in ((wide, dtype), (norms, torch.float32)):
        total = sum(math.prod(shape) for _, shape, _ in part)
        if not total:
            continue
        flat = torch.randn(total, generator=gen, device=device, dtype=dt)
        at = 0
        for name, shape, kind in part:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            t.mul_({"matrix": 1.0 / math.sqrt(shape[0]), "embed": EMBED_STD,
                    "bias": BIAS_STD, "norm": NORM_STD}[kind])
            out[name] = t
    return out


class Weights(collections.abc.Mapping):
    """name -> tensor over every parameter, made a group at a time when
    first asked for (the last group is kept), so that copying them into a
    model in its parameter order holds one group beside the model."""

    def __init__(self, m: Mapping, seed: int, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        self.m, self.seed, self.device = m, int(seed), torch.device(device)
        self.dtype = dtype or DTYPES[m["torch_dtype"]]
        self._groups = groups(m)
        self._where = {name: gi for gi, (_, leaves) in enumerate(self._groups)
                       for name, _, _ in leaves}
        self._cached: Tuple[int, Dict[str, torch.Tensor]] = (-1, {})

    def group(self, gi: int) -> Dict[str, torch.Tensor]:
        if self._cached[0] != gi:
            self._cached = (-1, {})      # free the last group first
            self._cached = (gi, make_group(self._groups[gi][1], self.seed, gi,
                                           self.device, self.dtype))
        return self._cached[1]

    def by_group(self, name: str) -> Dict[str, torch.Tensor]:
        """The group ``name`` ("embed", "head", "final_norm", "layers.3"):
        its tensors by their short names (``attn.wq``, ``ln1``, ...)."""
        gi = [g for g, (gname, _) in enumerate(self._groups) if gname == name][0]
        prefix = "" if not name.startswith("layers.") else name + "."
        return {k[len(prefix):]: t for k, t in self.group(gi).items()}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.group(self._where[name])[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)
