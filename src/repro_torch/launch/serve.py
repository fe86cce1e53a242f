"""The serving launcher's model executor.

Port of the executor half of ``repro/launch/serve.py``: a replica answers a
reuse-store miss by running the model's prefill on the request's token
prompt and returning the argmax of the last position's logits.  ``main()``
(the fleet CLI) comes with the ``ServingFleet`` slice.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..serving.engine import ServeRequest


def make_request(i: int, service: str, emb: np.ndarray, seq_len: int, vocab: int,
                 threshold: float = 0.9) -> ServeRequest:
    """A request whose payload is a token prompt derived from its embedding,
    ``(|emb[:seq_len]| * 1e4).astype(int64) % vocab``, as the reference's
    ``make_req`` derives it."""
    tokens = (np.abs(emb[:seq_len]) * 1e4).astype(np.int64) % vocab
    return ServeRequest(i, service, emb,
                        payload={"tokens": torch.from_numpy(tokens.astype(np.int32))[None, :]},
                        threshold=threshold)


def make_executor(model, seq_len: int) -> Callable[[List[ServeRequest]], List[int]]:
    """``execute(reqs) -> [argmax token of each request's last position]``.

    The reference prefills each request alone (batch 1) with ``max_len =
    seq_len + 8``.  A miss group's prompts all have ``seq_len`` tokens
    (``make_request``), so they run here as one (n, seq_len) prefill: each
    row's logits are the same function of its own tokens, so the tokens are
    the same."""
    max_len = seq_len + 8

    def execute(reqs: List[ServeRequest]) -> List[int]:
        if not reqs:
            return []
        tokens = torch.cat([r.payload["tokens"] for r in reqs]).to(model.device)
        logits, _ = model.prefill({"tokens": tokens}, max_len)
        return logits[:, -1].argmax(dim=-1).tolist()

    return execute
