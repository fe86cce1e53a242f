"""Carry state from the JAX package into the port.

The state of the ported slices is the LSH family, the reuse store's
contents, each model family's weights and cache, and a training state.
All arrive as numpy arrays (``np.asarray`` of the JAX package's
``LSH.rotations`` / ``LSH.planes``, the fields of a ``StoreExport``, and
``jax.tree.map(np.asarray, ...)`` of a model's ``init`` / ``prefill`` or of
a train state), or as the CPU tensors ``training.checkpoint.read`` gives of
a reference checkpoint, so this module needs neither package's imports
beyond the port's own.
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
    """A numpy array (or a tensor) as a tensor; ml_dtypes' bfloat16 (JAX's)
    is carried over bit for bit."""
    if isinstance(a, torch.Tensor):
        return a
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


def _row(value, index: tuple):
    """``value[index]`` of an array or a tensor."""
    return value[index] if isinstance(value, torch.Tensor) else np.asarray(value)[index]


Leaves = Iterator[Tuple[str, Any]]


def _stacked(prefix: str, tree: Mapping, dims: int) -> Leaves:
    """The leaves of a subtree stacked over ``dims`` leading axes, row by
    row: ``{prefix}.{i}[.{j}].{leaf}``, the port's ``ModuleList`` names."""
    for leaf, value in _leaves(tree):
        for idx in np.ndindex(*tuple(value.shape)[:dims]):
            yield ".".join([prefix, *map(str, idx), leaf]), _row(value, idx)


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
                yield f"layers.{g * model.group + i}.{leaf}", _row(stacked, (g,))


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


def model_from_jax(cfg, params_np: Mapping, device: DeviceLike = None, *,
                   trainable: bool = False):
    """The port's model for ``cfg`` (``models.build_model``, ``trainable``
    as there) holding the JAX model's ``init`` tree, whatever the family.

    ``params_np`` is that tree with numpy leaves.  Every leaf must land on a
    parameter of the same shape (cast to the parameter's dtype), and every
    parameter must receive one."""
    model = build_model(cfg, device, trainable=trainable)
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


def load_params(model: torch.nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Copy ``params`` (the port's parameter names, every one of them) into
    ``model``, for instance another model's ``named_parameters()``."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameters differ: {sorted(set(own) ^ set(params))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(params[name])


def _is_qleaf(x) -> bool:
    return isinstance(x, Mapping) and set(x) == {"q", "scale"}


def _has_qleaf(tree: Mapping) -> bool:
    return any(_is_qleaf(v) or (isinstance(v, Mapping) and _has_qleaf(v))
               for v in tree.values())


def _part(tree: Mapping, key: str) -> dict:
    """``tree`` with each int8 moment ``{"q", "scale"}`` replaced by its
    ``key`` entry."""
    return {k: v[key] if _is_qleaf(v) else _part(v, key) if isinstance(v, Mapping) else v
            for k, v in tree.items()}


def _named(model, tree: Mapping, names, what: str, device) -> Dict[str, Any]:
    """A reference tree keyed like the parameters (``params``, a moment or
    the error feedback) -> {port name: tensor on device}, int8 moments as
    ``{"q", "scale"}``; strict on missing and extra leaves."""
    def one(t: Mapping) -> Dict[str, torch.Tensor]:
        out = {}
        for name, value in _family_leaves(model, t):
            if name not in names:
                raise KeyError(f"{what}: the port has no parameter {name!r}")
            out[name] = _tensor(value).to(device)
        missing = sorted(set(names) - set(out))
        if missing:
            raise ValueError(f"{what}: the JAX tree has no value for {missing[:5]}")
        return out

    if not _has_qleaf(tree):
        return one(tree)
    q, scale = one(_part(tree, "q")), one(_part(tree, "scale"))
    return {n: {"q": q[n], "scale": scale[n]} for n in q}


def train_state_from_jax(cfg, state_np: Mapping, device: DeviceLike = None):
    """The reference's train state -> (the port's model with its masters,
    the port's state ``{"params", "opt"}``).

    ``state_np`` is ``{"params", "opt": {"step", "m", "v"[, "error"]}}``
    with numpy leaves (or CPU tensors): ``params`` the fp32 masters, ``m``
    and ``v`` float32 or bfloat16 arrays or int8 ``{"q", "scale"}`` dicts,
    ``error`` the compression residuals.  Leaves map as ``model_from_jax``
    maps them (a stacked group split per layer, an int8 moment's rows and
    scales alike), strictly.  The state's ``params`` are the returned
    model's own parameter tensors (``training.init_state``'s layout)."""
    dev = resolve_device(device)
    model = model_from_jax(cfg, state_np["params"], dev, trainable=True)
    params = {name: p.detach() for name, p in model.named_parameters()}
    opt_np = state_np["opt"]
    extra = sorted(set(opt_np) - {"step", "m", "v", "error"})
    if extra:
        raise KeyError(f"unknown optimizer state {extra}")
    opt = {"step": _tensor(opt_np["step"]).to(dev, torch.int32).reshape(())}
    for key in ("m", "v", "error"):
        if key in opt_np:
            opt[key] = _named(model, opt_np[key], params, f"opt/{key}", dev)
    return model, {"params": params, "opt": opt}


def cache_from_jax(cache_np: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A JAX model's cache (numpy leaves) on the port's device, same keys,
    layout and dtype: every family's port keeps the reference's layout
    (DecoderLM ``{"k{i}", "v{i}"}``: (n_groups, B, W, KV, D); hybrid ``ssm``,
    ``conv``, ``k``, ``v``, ``ssm_tail``, ``conv_tail``; xLSTM ``mC`` ..
    ``sbuf``; encdec ``k``, ``v``, ``xk``, ``xv``)."""
    dev = resolve_device(device)
    return {k: _tensor(v).to(dev) for k, v in cache_np.items()}
