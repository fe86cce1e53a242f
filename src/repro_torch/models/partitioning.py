"""Logical-axis partitioning: map model axes onto a device mesh.

Port of ``repro/models/partitioning.py`` on DTensor.  Every activation and
parameter dimension has a *logical* name (batch, seq, embed, heads, kv,
head_dim, ff, experts, vocab, kv_seq, ...).  A rule set maps logical names
to mesh axes; ``spec(*names)`` gives the ``PartitionSpec`` (one entry a
tensor dimension: None, a mesh axis, or a tuple of mesh axes), and
``placements`` turns a spec into DTensor placements (``Shard(d)`` on each
mesh dimension that shards tensor dimension d, ``Replicate()`` on the
others).  ``shard(x, *names)`` redistributes a DTensor ``x`` to its spec
when a mesh is active, the counterpart of ``with_sharding_constraint``; it
is a no-op without a mesh and for a plain tensor, so the same model code
runs in the one-device tests.

Default rules implement the framework's parallelism layout:
  batch   -> ('pod', 'data')   data parallelism (hierarchical across pods)
  heads/ff/experts/vocab -> 'model'   tensor/expert parallelism
  kv_seq  -> 'model'           context parallelism for huge KV caches

A mesh here is anything with ``mesh_dim_names`` and ``shape``: a
``torch.distributed.device_mesh.DeviceMesh``, or ``AbstractMesh`` (axis
names and sizes without devices, for deriving shardings of a mesh this
process does not have).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]
Axes = Union[None, str, Tuple[str, ...]]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), a mesh axis name, or
    a tuple of mesh axis names (sharded over their product, major first).
    As in JAX, a tuple of one axis is that axis and an empty tuple None."""

    def __new__(cls, *parts: Axes):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple) else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's axis names and sizes, without devices or process groups."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} differ in rank")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axis_names)
        self.ndim = len(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, axes: Axes) -> int:
    """The number of shards of ``axes`` (one axis name or a tuple) on ``mesh``."""
    if axes is None:
        return 1
    names = axis_names(mesh)
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= tuple(mesh.shape)[names.index(a)]
    return n


def default_rules(mesh) -> Rules:
    axes = axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    model = "model" if "model" in axes else None
    return {
        "batch": batch,
        "seq": None,
        "dec_seq": None,
        "embed": None,
        "heads": model,
        "kv": None,        # kv heads often < model axis; replicate by default
        "head_dim": None,
        "ff": model,
        "experts": model,
        "expert_cap": None,
        "vocab": model,
        "kv_seq": model,   # context parallelism for 500k-token caches
        "state": None,
        "layers": None,
        "frames": None,
    }


def set_mesh(mesh, rules: Optional[Rules] = None) -> None:
    _state.mesh = mesh
    _state.rules = dict(default_rules(mesh), **(rules or {}))


def get_mesh():
    return getattr(_state, "mesh", None)


def get_rules() -> Rules:
    r = getattr(_state, "rules", None)
    return r if r is not None else default_rules(None)


def spec(*logical_axes: Optional[str]) -> PartitionSpec:
    rules = get_rules()
    return P(*(None if name is None else rules.get(name) for name in logical_axes))


def fit(spec_: Sequence[Axes], shape: Sequence[int], mesh) -> PartitionSpec:
    """``spec_`` padded to ``len(shape)`` entries, with the sharding dropped on
    the dims that its mesh axes do not divide (a vocabulary of 256206 over 16
    shards, a global batch of 1): those stay replicated."""
    parts = list(spec_) + [None] * (len(shape) - len(spec_))
    return P(*(None if axes is not None and dim % axis_size(mesh, axes) else axes
               for dim, axes in zip(shape, parts)))


def placements(spec_: Sequence[Axes], mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec_`` on ``mesh``: ``Shard(d)`` on every mesh
    dimension that shards tensor dimension d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec_):
        for a in () if axes is None else (axes,) if isinstance(axes, str) else axes:
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of {tuple(spec_)}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def replicated_placements(mesh) -> Tuple[Any, ...]:
    """``Replicate()`` on every dimension of ``mesh``."""
    return placements((), mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements of its logical axes (a no-op
    without a mesh and for a plain tensor)."""
    mesh = get_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    assert len(logical_axes) == x.ndim, (logical_axes, tuple(x.shape))
    want = placements(fit(spec(*logical_axes), x.shape, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank, as a plain tensor whose
    gradient is the same on every rank (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    rep = replicated_placements(t.device_mesh)
    return t.redistribute(t.device_mesh, rep).to_local(grad_placements=rep)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, computed whole on every rank, as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor (``t`` as it is otherwise)."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, replicated_placements(ref.device_mesh))


def _local(t, mesh, want, grad):
    return t.redistribute(mesh, want).to_local(grad_placements=grad) if is_dtensor(t) else t


def batch_local(fn, x: torch.Tensor, *weights):
    """``fn(x, *weights)`` run on this rank's shard of the batch, with the
    weights (dicts of tensors, or tensors) gathered whole, the counterpart
    of a ``shard_map`` over the batch axes: for the blocks whose ops have
    no DTensor sharding rules (xLSTM's and Mamba2's recurrences).  A plain
    ``x`` runs ``fn`` as it is.  The rank's weight gradients are partial
    sums over the batch axes (replicated over the others), and the output
    keeps x's batch sharding (dim 0)."""
    if not is_dtensor(x):
        return fn(x, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    xp = placements(fit(spec("batch", *(None,) * (x.ndim - 1)), x.shape, mesh), mesh)
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in xp)
    rep = replicated_placements(mesh)
    local_w = [{k: _local(t, mesh, rep, grad) for k, t in w.items()} if isinstance(w, dict)
               else _local(w, mesh, rep, grad) for w in weights]
    out = fn(_local(x, mesh, xp, xp), *local_w)
    return DTensor.from_local(out, mesh, xp)


def named_sharding(*logical_axes: Optional[str]):
    """(mesh, placements) of the logical axes on the active mesh, or None
    without one."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return mesh, placements(spec(*logical_axes), mesh)


class use_mesh:
    """Context manager: activate (mesh, rules) for model code; nests, and
    restores the enclosing mesh and rules on exit."""

    def __init__(self, mesh, rules: Optional[Rules] = None):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        self._prev = (get_mesh(), getattr(_state, "rules", None))
        set_mesh(self.mesh, self.rules)
        return self

    def __exit__(self, *exc):
        _state.mesh, _state.rules = self._prev
        return False
