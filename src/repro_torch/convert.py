"""Carry state from the JAX package into the port.

The state of the ported slices is the LSH family, the reuse store's
contents, and each model family's weights and cache.  All arrive as numpy
arrays (``np.asarray`` of the JAX package's ``LSH.rotations`` /
``LSH.planes``, the fields of a ``StoreExport``, and ``jax.tree.map(
np.asarray, ...)`` of a model's ``init`` / ``prefill``), so this module
needs neither package's imports beyond the port's own.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.lsh import LSH, LSHParams
from .core.reuse_store import ReuseStore
from .device import DeviceLike, resolve_device
from .models import DecoderLM, build_model


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


Leaves = Iterator[Tuple[str, Any]]


def _stacked(prefix: str, tree: Mapping, dims: int) -> Leaves:
    """The leaves of a subtree stacked over ``dims`` leading axes, row by
    row: ``{prefix}.{i}[.{j}].{leaf}``, the port's ``ModuleList`` names."""
    for leaf, value in _leaves(tree):
        value = np.asarray(value)
        for idx in np.ndindex(*value.shape[:dims]):
            yield ".".join([prefix, *map(str, idx), leaf]), value[idx]


def _decoder_leaves(model: DecoderLM, params_np: Mapping) -> Leaves:
    """Each ``layers_{i}`` leaf is stacked over groups: its row ``g`` is
    layer ``g * len(pattern) + i`` (MoE blocks' ``moe.*`` leaves too)."""
    for key, value in params_np.items():
        if not key.startswith("layers_"):
            yield from _leaves({key: value})
            continue
        i = int(key.split("_", 1)[1])
        for leaf, stacked in _leaves(value):
            for g in range(model.n_groups):
                yield f"layers.{g * model.group + i}.{leaf}", np.asarray(stacked)[g]


# the stacked subtrees of each family's JAX tree and their stacked axes:
# hybrid main (G, P, ...), tail (T, ...); xLSTM mlstm (G, n_mlstm, ...),
# slstm (G, ...); encdec enc_layers, dec_layers (L, ...)
_STACKED = {"HybridModel": {"main": 2, "tail": 1},
            "XLSTMModel": {"mlstm": 2, "slstm": 1},
            "EncDecModel": {"enc_layers": 1, "dec_layers": 1}}


def _family_leaves(model, params_np: Mapping) -> Leaves:
    if isinstance(model, DecoderLM):
        yield from _decoder_leaves(model, params_np)
        return
    stacked = _STACKED[type(model).__name__]
    for key, value in params_np.items():
        if key in stacked:
            yield from _stacked(key, value, stacked[key])
        else:
            yield from _leaves({key: value})


def model_from_jax(cfg, params_np: Mapping, device: DeviceLike = None):
    """The port's model for ``cfg`` (``models.build_model``) holding the JAX
    model's ``init`` tree, whatever the family.

    ``params_np`` is that tree with numpy leaves.  Every leaf must land on a
    parameter of the same shape (cast to the parameter's dtype), and every
    parameter must receive one."""
    model = build_model(cfg, device)
    own = dict(model.named_parameters())
    loaded = set()
    for name, value in _family_leaves(model, params_np):
        if name not in own:
            raise KeyError(f"the port's {type(model).__name__} has no parameter {name!r}")
        t = _tensor(value)
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} vs {tuple(own[name].shape)}")
        with torch.no_grad():
            own[name].copy_(t)
        loaded.add(name)
    missing = sorted(set(own) - loaded)
    if missing:
        raise ValueError(f"the JAX tree has no value for {missing[:5]}")
    return model


def cache_from_jax(cache_np: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A JAX model's cache (numpy leaves) on the port's device, same keys,
    layout and dtype: every family's port keeps the reference's layout
    (DecoderLM ``{"k{i}", "v{i}"}``: (n_groups, B, W, KV, D); hybrid ``ssm``,
    ``conv``, ``k``, ``v``, ``ssm_tail``, ``conv_tail``; xLSTM ``mC`` ..
    ``sbuf``; encdec ``k``, ``v``, ``xk``, ``xv``)."""
    dev = resolve_device(device)
    return {k: _tensor(v).to(dev) for k, v in cache_np.items()}
