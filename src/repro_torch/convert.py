"""Carry state from the JAX package into the port.

The state of the ported slices is the LSH family, the reuse store's
contents, and a decoder LM's weights and KV cache.  All arrive as numpy
arrays (``np.asarray`` of the JAX package's ``LSH.rotations`` /
``LSH.planes``, the fields of a ``StoreExport``, and ``jax.tree.map(
np.asarray, ...)`` of ``DecoderLM.init`` / ``prefill``), so this module
needs neither package's imports beyond the port's own.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.lsh import LSH, LSHParams
from .core.reuse_store import ReuseStore
from .device import DeviceLike, resolve_device
from .models.transformer import DecoderLM


def lsh_from_arrays(params: LSHParams, rotations: Optional[np.ndarray] = None,
                    planes: Optional[np.ndarray] = None,
                    device: DeviceLike = None) -> LSH:
    """The port's ``LSH`` with the given (T, K, D, D) rotations or (T, bits,
    D) planes instead of its own seeded draw."""
    return LSH(params, device, rotations=rotations, planes=planes)


def store_from_export(params: LSHParams, ids: Sequence[int], embeddings: np.ndarray,
                      results: Sequence[Any], buckets: np.ndarray, *, capacity: int,
                      device: DeviceLike = None) -> ReuseStore:
    """A port ``ReuseStore`` holding a ``StoreExport``'s entries.

    The entries land through ``insert_batch(..., buckets=)``, so they keep
    their admission-time table placement; ``ids`` are the source slot ids
    (informational: the store allocates its own, in the export's order).
    """
    n = len(ids)
    if not (len(embeddings) == len(results) == len(buckets) == n):
        raise ValueError("ids, embeddings, results and buckets differ in length")
    store = ReuseStore(params, capacity=capacity, device=device)
    if n:
        store.insert_batch(np.asarray(embeddings, np.float32), list(results),
                           buckets=np.asarray(buckets))
    return store


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; ml_dtypes' bfloat16 (JAX's) is carried
    over bit for bit."""
    a = np.array(a, order="C")          # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def decoder_lm_from_jax(cfg, params_np: Mapping, device: DeviceLike = None) -> DecoderLM:
    """The port's ``DecoderLM`` holding the JAX ``DecoderLM.init`` tree.

    ``params_np`` is that tree with numpy leaves.  Each ``layers_{i}`` leaf
    is stacked over groups: its row ``g`` is layer ``g * len(pattern) + i``.
    Every leaf must land on a parameter of the same shape (cast to the
    parameter's dtype), and every parameter must receive one."""
    model = DecoderLM(cfg, device)
    own = dict(model.named_parameters())
    loaded = set()

    def put(name: str, value) -> None:
        if name not in own:
            raise KeyError(f"the port's DecoderLM has no parameter {name!r}")
        t = _tensor(value)
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} vs {tuple(own[name].shape)}")
        with torch.no_grad():
            own[name].copy_(t)
        loaded.add(name)

    for key, value in params_np.items():
        if not key.startswith("layers_"):
            put(key, value)
            continue
        i = int(key.split("_", 1)[1])
        for leaf, stacked in _leaves(value):
            for g in range(model.n_groups):
                put(f"layers.{g * model.group + i}.{leaf}", np.asarray(stacked)[g])
    missing = sorted(set(own) - loaded)
    if missing:
        raise ValueError(f"the JAX tree has no value for {missing[:5]}")
    return model


def cache_from_jax(cache_np: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A JAX ``DecoderLM`` KV cache (``{"k{i}", "v{i}"}``: (n_groups, B, W,
    KV, D), numpy leaves) on the port's device, same layout and dtype."""
    dev = resolve_device(device)
    return {k: _tensor(v).to(dev) for k, v in cache_np.items()}
