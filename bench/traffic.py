"""The one traffic generator: task embeddings of a mix (``traffic/<mix>.json``)
for a closed loop of clients, made from the run's seed on the device.

A mix names a camera process (or none) and a novel share.  A camera is the
paper's ``high``-correlation stream (``data/synthetic.py::make_stream`` of
the port, vectorised over clients and rounds with the same ``DatasetSpec``
values): runs whose lengths are geometric with mean ``run_length`` (a new run
starts at each frame with probability 1 / ``run_length``), each opening at a
random sub-centre plus ``item_noise`` and drifting by ``walk_noise`` a frame.
Each round a seeded ``novel_share`` of the clients, exactly
``round(share * clients)``, send a novel task instead: a direction uniform on
the sphere.  With no camera process every task is novel.

The sub-centres come from the dataset's own seed (numpy, as the paper's
generator draws them), the streams from the run's seed (torch, on the
device), so one seed gives the same rows on the same device.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from bench.weights import sub_seed, torch_generator


def centers(cam: Mapping) -> np.ndarray:
    """(n_classes * subs_per_class, dim) unit sub-centres of a dataset
    (``DatasetSpec.centers``)."""
    rng = np.random.default_rng(cam["centers_seed"])
    d = cam["dim"]
    cls = rng.standard_normal((cam["n_classes"], d))
    cls = cls / np.maximum(np.linalg.norm(cls, axis=-1, keepdims=True), 1e-12)
    cls = cls.astype(np.float32)
    noise = rng.standard_normal((cam["n_classes"], cam["subs_per_class"], d)) / np.sqrt(d)
    subs = (cls[:, None, :] + cam["sub_spread"] * noise).reshape(-1, d).astype(np.float32)
    return subs / np.maximum(np.linalg.norm(subs, axis=-1, keepdims=True), 1e-12)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class Traffic:
    """A mix's rows for ``clients`` clients from one seed; ``part`` keeps
    two streams of one seed apart (the window's rounds, the history that
    fills the stores)."""

    def __init__(self, mix: Mapping, seed: int, clients: int, device: torch.device,
                 dim: int = 64):
        self.mix, self.seed, self.clients = mix, int(seed), int(clients)
        self.device = torch.device(device)
        cam = mix.get("cameras")
        self.dim = cam["dim"] if cam else dim
        self.subs = torch.from_numpy(centers(cam)).to(self.device) if cam else None

    def rounds(self, n_rounds: int, part: str = "traffic") -> np.ndarray:
        """(n_rounds, clients, dim) float32 unit rows, round by round."""
        gen = torch_generator(self.seed, part, self.device)
        r, c, d = int(n_rounds), self.clients, self.dim
        share = float(self.mix["novel_share"])
        kw = {"generator": gen, "device": self.device}
        if self.subs is None or share >= 1.0:
            return _unit(torch.randn(r, c, d, **kw)).cpu().numpy()
        x = self._cameras(r, c, d, kw)
        k = round(share * c)
        if k:
            novel = torch.rand(r, c, **kw).argsort(dim=1)[:, :k]          # (r, k) clients
            x.scatter_(1, novel[..., None].expand(r, k, d),
                       _unit(torch.randn(r, k, d, **kw)))
        return x.cpu().numpy()

    def _cameras(self, r: int, c: int, d: int, kw) -> torch.Tensor:
        cam = self.mix["cameras"]
        start = torch.rand(r, c, **kw) < 1.0 / cam["run_length"]
        start[0] = True
        sub = torch.randint(len(self.subs), (r, c), **kw)
        first = self.subs[sub] + cam["item_noise"] * torch.randn(r, c, d, **kw) / math.sqrt(d)
        walk = cam["walk_noise"] * torch.randn(r, c, d, **kw) / math.sqrt(d)
        before = torch.cumsum(walk, dim=0) - walk                          # sum of steps < r
        steps = torch.arange(r, device=self.device)[:, None].expand(r, c)
        opened = torch.cummax(torch.where(start, steps, torch.zeros_like(steps)), dim=0).values
        at = opened[..., None].expand(r, c, d)
        x = first.gather(0, at) + before - before.gather(0, at)
        return _unit(x)

    def history(self, n: int) -> np.ndarray:
        """(n, dim) rows of the same mix from a stream of its own, round by
        round: the earlier tasks whose results fill the stores."""
        rows = self.rounds(-(-int(n) // self.clients), part="fill")
        return rows.reshape(-1, self.dim)[:n]


def prompts(seed: int, n: int, length: int, vocab: int, device: torch.device
            ) -> np.ndarray:
    """(n, length) int32 token ids, uniform over the vocabulary: task ``i``
    sends prompt ``i % n``."""
    gen = torch_generator(seed, "prompts", device)
    return torch.randint(vocab, (n, length), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32).cpu().numpy()


def sample_mask(seed: int, n: int, share: float) -> np.ndarray:
    """(n,) which task ids the correctness check may sample (numpy, seeded)."""
    return np.random.default_rng(sub_seed(seed, "sample")).random(n) < share

